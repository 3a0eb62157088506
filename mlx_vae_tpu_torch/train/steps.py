"""Train, eval and monitor steps, single device (counterpart of
``mlx_vae_tpu/train/steps.py:57-226``).

One ``train_step`` runs the batch's forward (encoder, decoder with fused CE
on the ``cfg.use_pallas`` route), all five loss components, the backward,
the joint global-norm clip and one Adam update per component
(``{"encoder", "decoder"[, "predictor"]}``, separate states). Params and
states are updated in place (``train/optim.py``); metrics come back as 0-d
tensors on the device, so a step never waits for the host.

Randomness: the JAX step splits its key into the reparameterization noise,
the teacher-forcing flips and the dropout key. Each step here draws the same
three from a ``torch.Generator`` on the batch's device (:func:`draw_noise`),
or takes them as ``noise`` — a dict ``{"eps", "tf_mask"[, "keep_masks"]}`` —
so a test can hand both packages the same draws.

Multi-device steps (``make_dp_*``, the counterparts of the JAX
``make_shmap_*`` makers) are closures over a ``parallel/mesh.py:Mesh``; one
process runs each rank. They take the global batch (``x [B, L]``, or
``idx [B]`` / ``[K, B]`` into a corpus every rank holds) and keep this
data rank's contiguous ``B / data`` rows, as ``P('data')`` hands a shard
its block. Then, per step: the loss and its gradients on those rows, the
gradient mean over the data group (``parallel/comm.py:grad_mean_``), the
joint clip and Adam in place, so the params stay bitwise replicated over
the data group; the metrics are reduced over it by the JAX rules.

* ``mesh.model == 1``: the shard_map semantics. The loss is the
  single-device one on this rank's rows (the fused kernels run per rank
  unchanged; the mutual information and the collapse penalty are per-rank
  statistics), and this rank's noise is its own (:func:`mesh_noise`: a
  generator seeded per data rank, ``parallel/mesh.py:fold_seed``).
* ``mesh.model > 1``: the GSPMD semantics (``use_pallas`` off). The params
  are split by ``layouts`` (``parallel/mesh.py:param_layout``), the loss
  runs the tensor-parallel route over the global batch
  (``losses/complete.py``), and the noise is the global draw cut to this
  rank's rows, so the step equals the single-device step on the whole
  batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.losses.complete import complete_vae_loss
from mlx_vae_tpu_torch.losses.info import mutual_information
from mlx_vae_tpu_torch.models.encoder import dropout_masks, encoder_apply
from mlx_vae_tpu_torch.parallel.comm import grad_mean_, reduce_metrics
from mlx_vae_tpu_torch.train.optim import adam_update, clip_by_global_norm, split_global_norm
from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

_SCALAR_KEYS = (
    "total_loss", "recon_loss", "kl_loss", "weighted_kl", "collapse_penalty",
    "prop_loss", "weighted_prop_loss", "mutual_info", "mi_penalty",
)


def draw_noise(gen: torch.Generator, mcfg: ModelConfig, batch: int, length: int,
               tf_ratio) -> dict:
    """One step's noise from ``gen`` (on the device where it is used):
    ``eps [B, latent]`` ~ N(0, I), ``tf_mask [L]`` = uniform < ``tf_ratio``,
    and the dropout keep-masks when ``mcfg.apply_dropout``."""
    dev = gen.device
    noise = {
        "eps": torch.randn((batch, mcfg.latent_dim), generator=gen, device=dev),
        "tf_mask": torch.rand((length,), generator=gen, device=dev) < tf_ratio,
    }
    if mcfg.apply_dropout:
        noise["keep_masks"] = dropout_masks(gen, mcfg, batch, length)
    return noise


def _scalar_metrics(loss_dict) -> dict:
    m = {k: loss_dict[k].detach() for k in _SCALAR_KEYS}
    m["mu_abs_max"] = loss_dict["mu"].detach().abs().max()
    m["logvar_min"] = loss_dict["logvar"].detach().min()
    m["logvar_max"] = loss_dict["logvar"].detach().max()
    return m


def _loss(params, mcfg, tcfg, x, conditions, noise, beta, training=True, mesh=None) -> dict:
    return complete_vae_loss(
        params["encoder"], params["decoder"], params.get("predictor"), mcfg,
        x, conditions, noise["eps"], noise["tf_mask"], noise.get("keep_masks"),
        beta=beta, lambda_prop=tcfg.lambda_prop, lambda_collapse=tcfg.lambda_collapse,
        free_bits=tcfg.free_bits, lambda_mi=tcfg.lambda_mi, target_mi=tcfg.target_mi,
        training=training, mesh=tp_mesh(mesh))


def tp_mesh(mesh):
    """``mesh`` where it has a model axis (the model code's tensor-parallel
    route), else None (the single-device model code)."""
    return mesh if mesh is not None and mesh.model > 1 else None


def _train_body(params: dict, opt_states: dict, mcfg: ModelConfig, tcfg: TrainConfig,
                x, conditions, noise: dict, beta, mesh=None, layouts=None):
    """Loss + grads (averaged over ``mesh``'s data group) + joint clip +
    per-component Adam."""
    names = ["encoder", "decoder"] + (["predictor"] if "predictor" in params else [])
    leaves = tree_leaves({n: params[n] for n in names})
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss_dict = _loss(params, mcfg, tcfg, x, conditions, noise, beta, mesh=mesh)
    flat = torch.autograd.grad(loss_dict["total_loss"], leaves, allow_unused=True)
    flat = iter([g if g is not None else torch.zeros_like(p) for g, p in zip(flat, leaves)])
    grads = tuple(tree_map(lambda _: next(flat), params[n]) for n in names)
    metrics = _scalar_metrics(loss_dict)
    lays = None
    if mesh is not None:
        grad_mean_(grads, mesh.data_group)
        metrics = reduce_metrics(metrics, mesh.data_group)
        lays = layouts and tuple(layouts[n] for n in names)
    if tcfg.grad_clip > 0:
        grads, grad_norm = clip_by_global_norm(grads, tcfg.grad_clip, tp_mesh(mesh), lays)
    else:
        grad_norm = split_global_norm(grads, tp_mesh(mesh), lays)
    for name, g in zip(names, grads):
        adam_update(params[name], g, opt_states[name], tcfg.learning_rate,
                    b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
                    bias_correction=tcfg.adam_bias_correction)
    metrics["grad_norm"] = grad_norm.detach()
    return params, opt_states, metrics


def train_step(params: dict, opt_states: dict, mcfg: ModelConfig, tcfg: TrainConfig,
               x, conditions, generator: Optional[torch.Generator], beta, tf_ratio,
               noise: Optional[dict] = None):
    """One optimization step; ``params`` / ``opt_states`` are updated in
    place and returned with the metrics. ``noise`` (optional) replaces the
    draws from ``generator``."""
    if noise is None:
        noise = draw_noise(generator, mcfg, x.shape[0], x.shape[1], tf_ratio)
    return _train_body(params, opt_states, mcfg, tcfg, x, conditions, noise, beta)


def _stack(metrics: list) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def multi_train_step(params: dict, opt_states: dict, mcfg: ModelConfig,
                     tcfg: TrainConfig, xs, conditions, generator, beta, tf_ratio,
                     noise: Optional[list] = None):
    """K optimization steps over ``xs [K, B, L]``, ``conditions [K, B, C]``
    (``noise``: optional list of K per-step noise dicts). Metrics come back
    stacked ``[K]`` per key."""
    out = []
    for k in range(xs.shape[0]):
        params, opt_states, m = train_step(params, opt_states, mcfg, tcfg, xs[k],
                                           conditions[k], generator, beta, tf_ratio,
                                           None if noise is None else noise[k])
        out.append(m)
    return params, opt_states, _stack(out)


@torch.no_grad()
def eval_step(params: dict, mcfg: ModelConfig, tcfg: TrainConfig, x, conditions,
              generator, beta, tf_ratio, noise: Optional[dict] = None) -> dict:
    """The loss forward only (true-train loss at TF=0, and validation)."""
    if noise is None:
        noise = draw_noise(generator, mcfg, x.shape[0], x.shape[1], tf_ratio)
    return _scalar_metrics(_loss(params, mcfg, tcfg, x, conditions, noise, beta,
                                 training=False))


def _gather(tokens_all, props_all, idx):
    return tokens_all[idx].to(torch.int32), props_all[idx]


def train_step_gather(params: dict, opt_states: dict, mcfg: ModelConfig,
                      tcfg: TrainConfig, tokens_all, props_all, idx, generator, beta,
                      tf_ratio, noise: Optional[dict] = None):
    """``train_step`` fed by a device-resident corpus: ``tokens_all [N, L]``
    (uint8 or int32), ``props_all [N, C]`` f32, ``idx [B]``."""
    x, c = _gather(tokens_all, props_all, idx)
    return train_step(params, opt_states, mcfg, tcfg, x, c, generator, beta, tf_ratio,
                      noise)


def multi_train_step_gather(params: dict, opt_states: dict, mcfg: ModelConfig,
                            tcfg: TrainConfig, tokens_all, props_all, idx, generator,
                            beta, tf_ratio, noise: Optional[list] = None):
    """``multi_train_step`` over a device-resident corpus; ``idx [K, B]``."""
    out = []
    for k in range(idx.shape[0]):
        x, c = _gather(tokens_all, props_all, idx[k])
        params, opt_states, m = train_step(params, opt_states, mcfg, tcfg, x, c,
                                           generator, beta, tf_ratio,
                                           None if noise is None else noise[k])
        out.append(m)
    return params, opt_states, _stack(out)


def eval_step_gather(params: dict, mcfg: ModelConfig, tcfg: TrainConfig, tokens_all,
                     props_all, idx, generator, beta, tf_ratio,
                     noise: Optional[dict] = None) -> dict:
    """``eval_step`` fed by a device-resident corpus (``idx [B]``)."""
    x, c = _gather(tokens_all, props_all, idx)
    return eval_step(params, mcfg, tcfg, x, c, generator, beta, tf_ratio, noise)


@torch.no_grad()
def monitor_step(encoder_params: dict, mcfg: ModelConfig, x, conditions, mesh=None) -> dict:
    """Latent statistics and the monitoring MI (the ``+1e-8`` variant), on
    the rows given (every rank of a mesh gives the same rows)."""
    mu, logvar = encoder_apply(encoder_params, mcfg, x, conditions, mesh=tp_mesh(mesh))
    return {
        "mu_min": mu.min(), "mu_max": mu.max(),
        "mu_mean": mu.mean(), "mu_std": mu.std(unbiased=False),
        "logvar_min": logvar.min(), "logvar_max": logvar.max(),
        "logvar_mean": logvar.mean(), "logvar_std": logvar.std(unbiased=False),
        "mutual_info": mutual_information(mu, logvar, eps=1e-8),
    }


# ------------------------------------------------------------ multi-device


def local_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This data rank's contiguous block of ``t``'s batch dimension ``dim``."""
    n = t.shape[dim] // mesh.data
    return t.narrow(dim, mesh.data_rank * n, n)


def mesh_noise(generator: torch.Generator, mesh, mcfg: ModelConfig, batch: int, length: int,
               tf_ratio) -> dict:
    """This rank's noise for a global batch of ``batch`` rows: its own draw
    for its ``batch / data`` rows (``mesh.model == 1``; ``generator`` is
    seeded per data rank), or the global draw (``generator`` seeded alike
    on every rank) cut to its rows."""
    if mesh.model == 1:
        return draw_noise(generator, mcfg, batch // mesh.data, length, tf_ratio)
    noise = draw_noise(generator, mcfg, batch, length, tf_ratio)
    out = {"eps": local_rows(mesh, noise["eps"]), "tf_mask": noise["tf_mask"]}
    if "keep_masks" in noise:
        out["keep_masks"] = [local_rows(mesh, m) for m in noise["keep_masks"]]
    return out


def make_dp_train_step(mesh, mcfg: ModelConfig, tcfg: TrainConfig, layouts=None):
    """The mesh's train step (module docstring): ``step(params, opt_states,
    x [B, L], conditions [B, C], generator, beta, tf_ratio, noise=None)``,
    ``noise`` this rank's (:func:`mesh_noise`). ``layouts``: the split
    leaves, required when ``mesh.model > 1``."""
    def step(params, opt_states, x, conditions, generator, beta, tf_ratio, noise=None):
        if noise is None:
            noise = mesh_noise(generator, mesh, mcfg, x.shape[0], x.shape[1], tf_ratio)
        return _train_body(params, opt_states, mcfg, tcfg, local_rows(mesh, x),
                           local_rows(mesh, conditions), noise, beta, mesh, layouts)
    return step


def make_dp_train_step_gather(mesh, mcfg: ModelConfig, tcfg: TrainConfig, layouts=None):
    """:func:`make_dp_train_step` fed by a corpus every rank holds:
    ``step(params, opt_states, tokens_all, props_all, idx [B], generator,
    beta, tf_ratio, noise=None)``; this rank gathers its block of ``idx``."""
    def step(params, opt_states, tokens_all, props_all, idx, generator, beta, tf_ratio,
             noise=None):
        if noise is None:
            noise = mesh_noise(generator, mesh, mcfg, idx.shape[0], tokens_all.shape[1],
                               tf_ratio)
        x, c = _gather(tokens_all, props_all, local_rows(mesh, idx))
        return _train_body(params, opt_states, mcfg, tcfg, x, c, noise, beta, mesh, layouts)
    return step


def make_dp_multi_train_step_gather(mesh, mcfg: ModelConfig, tcfg: TrainConfig,
                                    layouts=None):
    """K gather-fed mesh steps: ``idx [K, B]`` split on axis 1 (``noise``:
    optional list of K of this rank's noise dicts). Metrics come back
    stacked ``[K]`` per key."""
    one = make_dp_train_step_gather(mesh, mcfg, tcfg, layouts)

    def step(params, opt_states, tokens_all, props_all, idx, generator, beta, tf_ratio,
             noise=None):
        out = []
        for k in range(idx.shape[0]):
            params, opt_states, m = one(params, opt_states, tokens_all, props_all, idx[k],
                                        generator, beta, tf_ratio,
                                        None if noise is None else noise[k])
            out.append(m)
        return params, opt_states, _stack(out)
    return step


def make_dp_eval_step(mesh, mcfg: ModelConfig, tcfg: TrainConfig):
    """The mesh's loss forward: ``step(params, x [B, L], conditions,
    generator, beta, tf_ratio, noise=None)``, metrics reduced over the data
    group."""
    @torch.no_grad()
    def step(params, x, conditions, generator, beta, tf_ratio, noise=None):
        if noise is None:
            noise = mesh_noise(generator, mesh, mcfg, x.shape[0], x.shape[1], tf_ratio)
        d = _loss(params, mcfg, tcfg, local_rows(mesh, x), local_rows(mesh, conditions),
                  noise, beta, training=False, mesh=mesh)
        return reduce_metrics(_scalar_metrics(d), mesh.data_group)
    return step


def make_dp_eval_step_gather(mesh, mcfg: ModelConfig, tcfg: TrainConfig):
    """:func:`make_dp_eval_step` fed by a corpus every rank holds (``idx [B]``)."""
    @torch.no_grad()
    def step(params, tokens_all, props_all, idx, generator, beta, tf_ratio, noise=None):
        if noise is None:
            noise = mesh_noise(generator, mesh, mcfg, idx.shape[0], tokens_all.shape[1],
                               tf_ratio)
        x, c = _gather(tokens_all, props_all, local_rows(mesh, idx))
        d = _loss(params, mcfg, tcfg, x, c, noise, beta, training=False, mesh=mesh)
        return reduce_metrics(_scalar_metrics(d), mesh.data_group)
    return step
