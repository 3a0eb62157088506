"""Training engine (counterpart of ``mlx_vae_tpu/train/trainer.py``).

Per epoch, as the JAX ``ARCVAETrainer``: the teacher-forced training pass
under the β and teacher-forcing schedules, the no-TF "true train loss" on
the first ``true_loss_batches`` unshuffled batches, validation at TF=0, and
the latent statistics with the monitoring MI on one ``min(64, N)``-row
batch; the loss-explosion guard (which, as in the reference, only skips the
batch from the accounting: its update has been applied); ``.npz``
checkpoints (async by default) and the history.

How it maps onto PyTorch on one device:

* Params and Adam states are updated in place by ``train/steps.py``. An
  async checkpoint therefore snapshots them with ``detach().clone()`` on the
  step's stream and records a CUDA event; the save thread waits on that
  event before it copies to the host, so the next epoch's steps cannot
  rewrite the leaves under the save.
* Each step's metrics are 0-d device tensors. They are stacked into one
  tensor, copied to pinned host memory with ``non_blocking=True`` and read
  ``LAG`` steps later (behind an event), so the host never waits for the
  device inside the pass; the eval passes dispatch every batch first and
  read back after.
* The batch order is the JAX trainer's exactly: ``np.random.default_rng``
  of the seed drives ``to_index_batches``. Randomness on the device comes
  from one ``torch.Generator`` on the device, seeded
  ``parallel/mesh.py:fold_seed(seed, data rank)`` (rank 0 on one device:
  a stream apart from the init's ``manual_seed(seed)``), through
  :meth:`ARCVAETrainer._next_noise` alone.
* The corpus lives on the device, per trainer (``uint8`` tokens when the
  vocabulary fits a byte), and steps take index batches
  (``train_step_gather``); ``host_data`` feeds host batches through
  ``utils/prefetch.py`` instead. Nothing is dropped: the trailing partial
  batch trains and evaluates like any other.
* ``steps_per_dispatch`` K runs K steps per ``multi_train_step_gather``
  call, with the JAX accounting of chunks and trailing partial chunks.
* Multi-device training runs one trainer per rank of a
  ``torch.distributed`` group (``parallel/``), by the JAX trainer's rules
  (:func:`mesh_plan`): a mesh only when ``data_parallel`` or
  ``model_parallel`` > 1 is asked for over more than one rank; with
  ``data_parallel`` every rank joins a ``(world / tp, tp)`` mesh, with
  ``model_parallel`` alone the first ``tp`` ranks form a ``(1, tp)`` mesh
  and the others stay idle (:attr:`ARCVAETrainer.idle`). Every rank
  shuffles with the same RNG and holds the whole corpus; the steps
  (``train/steps.py:make_dp_*``) keep its block of each batch. Partial
  batches are dropped when the data axis is split (a split smaller than one
  batch then reports ``+inf`` for every metric). Data-parallel noise comes
  from a generator seeded per data rank (``parallel/mesh.py:fold_seed``);
  tensor-parallel noise is the global draw cut to the rank's rows, so a
  tensor-parallel run equals the one-rank run with the same seed. With
  ``host_data`` a mesh runs one step per dispatch. Rank 0 alone writes
  checkpoints (full arrays, gathered over the model group) and the
  history; ``join_saves`` ends in a barrier; a load re-shards.
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(it, **kw):
        return it

from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.parallel import mesh as pmesh
from mlx_vae_tpu_torch.train import checkpoint as ckpt_io
from mlx_vae_tpu_torch.train.history import make_history, plot_history, save_history
from mlx_vae_tpu_torch.train.optim import adam_init
from mlx_vae_tpu_torch.train.steps import (
    draw_noise,
    eval_step,
    eval_step_gather,
    make_dp_eval_step,
    make_dp_eval_step_gather,
    make_dp_multi_train_step_gather,
    make_dp_train_step,
    make_dp_train_step_gather,
    mesh_noise,
    monitor_step,
    multi_train_step,
    multi_train_step_gather,
    train_step,
    train_step_gather,
)
from mlx_vae_tpu_torch.utils.prefetch import prefetch_to_device, to_device
from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

LAG = 4  # steps between a step's dispatch and the read of its metrics
_EVAL_KEYS = ("total_loss", "recon_loss", "kl_loss", "collapse_penalty", "prop_loss")


def mesh_plan(tcfg: TrainConfig, n_ranks: int) -> Optional[tuple]:
    """The mesh the JAX trainer would form over ``n_ranks`` devices, as
    ``(ranks, model_parallel)``, or None for one device (``data_parallel``
    on one device trains there). ``model_parallel`` above ``n_ranks``
    raises rather than train on fewer devices than asked for."""
    tp = max(1, tcfg.model_parallel)
    if tp > 1 and n_ranks < tp:
        raise ValueError(f"model_parallel={tp} requires at least {tp} devices; "
                         f"{n_ranks} visible")
    if not (tcfg.data_parallel or tp > 1) or n_ranks <= 1:
        return None
    # --model_parallel alone: pure tensor parallelism over the first tp ranks
    return tuple(range(n_ranks if tcfg.data_parallel else tp)), tp


class _Readback:
    """A step's (or a K-chunk's) metrics on their way to the host: stacked
    into one f32 tensor, copied to pinned memory without blocking, with an
    event to wait on; on the CPU the tensor itself."""

    def __init__(self, metrics: dict):
        self.keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in self.keys], dim=-1)
        self.event = None
        if vals.device.type == "cuda":
            self.host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(vals.device))
        else:
            self.host = vals

    def get(self) -> dict:
        """``{key: float}`` (``{key: [K] array}`` for a chunk)."""
        if self.event is not None:
            self.event.synchronize()
        a = self.host.numpy()
        if a.ndim == 1:
            return {k: float(a[i]) for i, k in enumerate(self.keys)}
        return {k: a[:, i] for i, k in enumerate(self.keys)}


class ARCVAETrainer:
    def __init__(
        self,
        params: dict,
        mcfg: ModelConfig,
        tcfg: TrainConfig,
        dataset,
        seed: Optional[int] = None,
    ):
        """``params`` is the ARCVAE param tree (``{"encoder", "decoder"[,
        "predictor"]}``) as f32 tensors; the trainer runs on their device."""
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.batch_size = tcfg.batch_size
        self.learning_rate = tcfg.learning_rate
        self.device = tree_leaves(params)[0].device

        # The mesh (None on one device; see the module docstring). A rank
        # outside a pure tensor-parallel mesh is idle: it trains nothing.
        self.mesh, self.layouts, self.idle = None, None, False
        plan = mesh_plan(tcfg, pmesh.world_size())
        if plan is not None:
            self.mesh = pmesh.make_mesh(plan[1], plan[0])
            self.idle = self.mesh is None
        if self.mesh is not None:
            if tcfg.batch_size % self.mesh.data != 0:
                raise ValueError(f"batch_size {tcfg.batch_size} must divide over "
                                 f"{self.mesh.data} data-parallel devices")
            if self.mesh.model > 1:
                if mcfg.use_pallas:
                    raise ValueError(
                        "model_parallel > 1 requires use_pallas=False: the fused "
                        "kernels hold whole gate/vocab blocks and have no "
                        "partitioning rule for model-sharded operands "
                        "(config.py TrainConfig.model_parallel)")
                self.layouts = pmesh.param_layout(params, self.mesh.model)
                params = pmesh.shard_params(self.mesh, params, self.layouts)

        seed = tcfg.seed if seed is None else seed
        # The noise stream is the seed folded with this data rank (0 where
        # the batch is not split), never ``manual_seed(seed)`` itself: the
        # CLIs draw the init from a CPU generator seeded ``seed``, and a CPU
        # trainer seeded alike would replay the init's values as its first
        # steps' noise.
        data_rank = (self.mesh.data_rank
                     if self.mesh is not None and self.mesh.model == 1 else 0)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(pmesh.fold_seed(seed, data_rank))
        self._shuffle_rng = np.random.default_rng(seed)

        self.checkpoint_dir = Path(tcfg.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

        # Token alphabet (set by the CLI when the dataset ships one), stored
        # in checkpoints beside the property stats.
        self.alphabet = None

        # In-flight async checkpoint save (at most one; see save_checkpoint).
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

        self.history = make_history()
        # train dispatches by their number of steps, over the trainer's life
        self.dispatch_steps: collections.Counter = collections.Counter()

        self.params = params
        self.opt_states = {name: adam_init(p) for name, p in params.items()}
        self._bind_steps()

        self._device_data = not tcfg.host_data
        # device-resident corpora of this trainer, by dataset identity (the
        # entry holds the dataset, so its id cannot be reused while cached)
        self._dev_arrays: Dict[int, tuple] = {}

    # ---------------------------------------------------------------- utils

    def _bind_steps(self) -> None:
        """The step functions of this trainer, with one signature each on
        one device and on a mesh (``train/steps.py``)."""
        m, t, mesh = self.mcfg, self.tcfg, self.mesh
        if mesh is None:
            self._step = lambda p, o, *a: train_step(p, o, m, t, *a)
            self._step_gather = lambda p, o, *a: train_step_gather(p, o, m, t, *a)
            self._multi = lambda p, o, *a: multi_train_step(p, o, m, t, *a)
            self._multi_gather = lambda p, o, *a: multi_train_step_gather(p, o, m, t, *a)
            self._eval = lambda p, *a: eval_step(p, m, t, *a)
            self._eval_gather = lambda p, *a: eval_step_gather(p, m, t, *a)
            return
        self._step = make_dp_train_step(mesh, m, t, self.layouts)
        self._step_gather = make_dp_train_step_gather(mesh, m, t, self.layouts)
        self._multi = None  # a mesh fed from the host runs one step a dispatch
        self._multi_gather = make_dp_multi_train_step_gather(mesh, m, t, self.layouts)
        self._eval = make_dp_eval_step(mesh, m, t)
        self._eval_gather = make_dp_eval_step_gather(mesh, m, t)

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and the history (rank 0)."""
        return pmesh.rank() == 0

    @property
    def _drop_partial(self) -> bool:
        """Partial batches are dropped only when the batch axis is split over
        ranks (data axis > 1): an indivisible remainder cannot split. A pure
        tensor-parallel mesh runs them as one device does."""
        return self.mesh is not None and self.mesh.data > 1

    def _next_noise(self, batch: int, length: int, tf_ratio: float,
                    steps: Optional[int] = None):
        """One step's noise (``train/steps.py:draw_noise``; on a mesh this
        rank's, ``mesh_noise``), or a list of ``steps`` of them for a
        K-chunk. Every device draw of the trainer goes through here, in the
        order the JAX trainer splits its key: the train steps, then the
        true-loss batches, then validation."""
        def one():
            if self.mesh is None:
                return draw_noise(self._generator, self.mcfg, batch, length, tf_ratio)
            return mesh_noise(self._generator, self.mesh, self.mcfg, batch, length, tf_ratio)
        return one() if steps is None else [one() for _ in range(steps)]

    def compute_beta(self, epoch: int) -> float:
        return self.tcfg.compute_beta(epoch)

    def compute_teacher_forcing_ratio(self, epoch: int, total_epochs: int) -> float:
        return self.tcfg.compute_teacher_forcing_ratio(epoch, total_epochs)

    def _batches(self, dataset, shuffle: bool):
        it = dataset.to_batches(self.batch_size, shuffle=shuffle,
                                rng=self._shuffle_rng if shuffle else None,
                                drop_last=self._drop_partial)
        return prefetch_to_device(it, size=2, device=self.device)

    def _dev_data(self, dataset):
        """Device-resident ``(tokens, normalized properties)`` of
        ``dataset``, uploaded once per trainer (uint8 when the vocabulary
        fits a byte)."""
        entry = self._dev_arrays.get(id(dataset))
        if entry is None:
            toks = dataset.molecules
            if self.mcfg.vocab_size <= 255:
                toks = toks.astype(np.uint8)
            entry = (dataset,
                     torch.as_tensor(toks).to(self.device),
                     torch.as_tensor(dataset.properties_normalized
                                     .astype(np.float32)).to(self.device))
            self._dev_arrays[id(dataset)] = entry
        return entry[1], entry[2]

    def _index_batches(self, dataset, shuffle: bool):
        """``[B]`` index tensors on the device, from the same shuffle RNG as
        ``_batches`` (so the batches are the same). The whole pass's
        indices cross to the device in one copy."""
        batches = list(dataset.to_index_batches(
            self.batch_size, shuffle=shuffle,
            rng=self._shuffle_rng if shuffle else None, drop_last=self._drop_partial))
        if not batches:
            return []
        flat = to_device(np.concatenate(batches).astype(np.int64), self.device)
        return list(torch.split(flat, [len(b) for b in batches]))

    # ---------------------------------------------------------------- epoch

    def train_epoch(self, epoch: int, total_epochs: int,
                    val_dataset=None) -> Dict[str, float]:
        beta = self.compute_beta(epoch)
        teacher_forcing_ratio = self.compute_teacher_forcing_ratio(epoch, total_epochs)

        t0 = time.perf_counter()
        self._train_epoch_batches(beta, teacher_forcing_ratio)
        dt = time.perf_counter() - t0
        tokens = len(self.dataset) * self.dataset.max_length
        print(f"   Throughput: {tokens / dt:,.0f} tokens/sec "
              f"({dt:.3f}s train pass)")

        true_train_metrics = self._compute_true_train_loss(
            epoch, num_batches=self.tcfg.true_loss_batches)

        if val_dataset is not None:
            val_metrics = self._validate(val_dataset, beta)
        else:
            val_metrics = {k: 0.0 for k in ("loss", "recon", "kl", "collapse", "prop")}

        stats = self._get_latent_stats()
        mi_value = float(stats["mutual_info"])

        return {
            "train_loss": true_train_metrics["loss"],
            "train_recon": true_train_metrics["recon"],
            "train_kl": true_train_metrics["kl"],
            "train_collapse": true_train_metrics["collapse"],
            "train_prop": true_train_metrics["prop"],
            "val_loss": val_metrics.get("loss", 0.0),
            "val_recon": val_metrics.get("recon", 0.0),
            "val_kl": val_metrics.get("kl", 0.0),
            "val_collapse": val_metrics.get("collapse", 0.0),
            "val_prop": val_metrics.get("prop", 0.0),
            "beta": beta,
            "teacher_forcing": teacher_forcing_ratio,
            "mutual_info": mi_value,
        }

    # ------------------------------------------------------------ train pass

    def _train_epoch_batches(self, beta: float,
                             teacher_forcing_ratio: float) -> Dict[str, float]:
        tcfg = self.tcfg
        total_loss, num_batches = 0.0, 0
        comp_sums = dict(recon=0.0, kl=0.0, collapse=0.0, prop=0.0)
        comp_count = 0
        tf = teacher_forcing_ratio
        L = self.dataset.max_length

        num_batches_total = len(self.dataset) // self.batch_size
        dev = self._device_data
        feed = (self._index_batches(self.dataset, shuffle=True) if dev
                else self._batches(self.dataset, shuffle=True))
        pbar = tqdm(feed, total=num_batches_total, desc="Training batches")

        # Lagged readback: each dispatch's metrics are read LAG dispatches
        # later, so the host queues steps without waiting for the device.
        pending = collections.deque()

        def account(batch_idx, m):
            nonlocal total_loss, num_batches, comp_count
            loss_val = float(m["total_loss"])

            if batch_idx == 0 or batch_idx % tcfg.component_sample_every == 0:
                comp_sums["recon"] += float(m["recon_loss"])
                comp_sums["kl"] += float(m["kl_loss"])
                comp_sums["collapse"] += float(m["collapse_penalty"])
                comp_sums["prop"] += float(m["prop_loss"])
                comp_count += 1

            # Explosion guard (reference trainer.py:369-401): diagnostics +
            # skip from accounting only (the update is already applied).
            if (not np.isfinite(loss_val) or loss_val > tcfg.explosion_max
                    or loss_val < tcfg.explosion_min):
                print(f"\n⚠️  WARNING: Loss explosion detected at batch {batch_idx}!")
                print(f"   Loss: {loss_val:.2e}")
                print(f"   Components: recon={float(m['recon_loss']):.2f}, "
                      f"kl={float(m['kl_loss']):.2f}, "
                      f"weighted_kl={float(m['weighted_kl']):.2f}, "
                      f"collapse={float(m['collapse_penalty']):.2f}")
                print(f"   Latent bounds: |μ|_max={float(m['mu_abs_max']):.3f} "
                      f"(expected ≤2), logvar=[{float(m['logvar_min']):.3f}, "
                      f"{float(m['logvar_max']):.3f}] (expected [-2, 0])")
                print("   Skipping this batch...")
                return

            total_loss += loss_val
            num_batches += 1
            if batch_idx % 10 == 0 and hasattr(pbar, "set_postfix"):
                pbar.set_postfix({"loss": f"{loss_val:.4f}"})

        K = 1 if self.mesh is not None and not dev else max(1, tcfg.steps_per_dispatch)
        chunk = []  # payloads awaiting a K-step dispatch
        if dev:
            toks_dev, props_dev = self._dev_data(self.dataset)

        def payload_rows(p):
            return p.shape[0] if dev else p[0].shape[0]

        def one_step(p):
            B = payload_rows(p)
            noise = self._next_noise(B, L, tf)
            if dev:
                return self._step_gather(self.params, self.opt_states, toks_dev, props_dev, p,
                                         None, beta, tf, noise)
            m, c = p
            return self._step(self.params, self.opt_states, m, c, None, beta, tf, noise)

        def push_one(first_idx, p):
            self.params, self.opt_states, metrics = one_step(p)
            self.dispatch_steps[1] += 1
            pending.append((first_idx, _Readback(metrics), 1))

        def dispatch_chunk(first_idx):
            noise = self._next_noise(self.batch_size, L, tf, steps=len(chunk))
            if dev:
                self.params, self.opt_states, metrics = self._multi_gather(
                    self.params, self.opt_states, toks_dev, props_dev,
                    torch.stack(chunk), None, beta, tf, noise)
            else:
                self.params, self.opt_states, metrics = self._multi(
                    self.params, self.opt_states,
                    torch.stack([m for m, _ in chunk]),
                    torch.stack([c for _, c in chunk]), None, beta, tf, noise)
            self.dispatch_steps[len(chunk)] += 1
            pending.append((first_idx, _Readback(metrics), len(chunk)))
            chunk.clear()

        def flush_pending(limit):
            while len(pending) > limit:
                first_idx, rb, k = pending.popleft()
                host = rb.get()
                if k == 1:
                    account(first_idx, host)
                else:
                    for j in range(k):
                        account(first_idx + j, {key: v[j] for key, v in host.items()})

        batch_idx = -1
        for batch_idx, payload in enumerate(pbar):
            if K > 1 and payload_rows(payload) == self.batch_size:
                chunk.append(payload)
                if len(chunk) == K:
                    dispatch_chunk(batch_idx - K + 1)
                    flush_pending(LAG)
                continue
            # single-step path (K == 1, or a trailing partial batch)
            if chunk:  # a partial batch arrived mid-chunk: flush what we have
                if len(chunk) == 1:
                    push_one(batch_idx - 1, chunk[0])
                    chunk.clear()
                else:
                    dispatch_chunk(batch_idx - len(chunk))
            push_one(batch_idx, payload)
            flush_pending(LAG)

        # drain the tail: any incomplete chunk, one step at a time
        if chunk and not getattr(self, "_warned_partial_chunk", False):
            self._warned_partial_chunk = True
            print(f"\n   Note: trailing partial chunk of {len(chunk)} batch(es) "
                  f"with steps_per_dispatch={K} runs as single steps; size the "
                  "dataset a multiple of batch_size*K to avoid this.")
        for j, p_ in enumerate(chunk):
            push_one(batch_idx - len(chunk) + 1 + j, p_)
        chunk.clear()
        flush_pending(0)

        return {
            "loss": total_loss / max(1, num_batches),
            "recon": comp_sums["recon"] / comp_count if comp_count else 0.0,
            "kl": comp_sums["kl"] / comp_count if comp_count else 0.0,
            "collapse": comp_sums["collapse"] / comp_count if comp_count else 0.0,
            "prop": comp_sums["prop"] / comp_count if comp_count else 0.0,
        }

    # ------------------------------------------------------------ eval paths

    def _eval_batches(self, dataset, beta: float, max_batches: Optional[int],
                      desc: str) -> Dict[str, float]:
        sums = dict(loss=0.0, recon=0.0, kl=0.0, collapse=0.0, prop=0.0)
        if max_batches is not None and max_batches <= 0:
            # Explicitly disabled (true_loss_batches=0): neutral zeros, before
            # any upload or dispatch. Never feeds the is_best comparison.
            return sums
        L = dataset.max_length
        # Dispatch every eval step first, read back after.
        readbacks = []
        dev = self._device_data
        if dev:
            toks_dev, props_dev = self._dev_data(dataset)
            feed = self._index_batches(dataset, shuffle=False)
        else:
            feed = self._batches(dataset, shuffle=False)
        for batch_idx, payload in enumerate(feed):
            if max_batches is not None and batch_idx >= max_batches:
                break
            if dev:
                noise = self._next_noise(payload.shape[0], L, 0.0)
                m = self._eval_gather(self.params, toks_dev, props_dev, payload, None, beta,
                                      0.0, noise)
            else:
                molecules, conditions = payload
                noise = self._next_noise(molecules.shape[0], L, 0.0)
                m = self._eval(self.params, molecules, conditions, None, beta, 0.0, noise)
            readbacks.append(_Readback({k: m[k] for k in _EVAL_KEYS}))
        for rb in readbacks:
            m = rb.get()
            sums["loss"] += m["total_loss"]
            sums["recon"] += m["recon_loss"]
            sums["kl"] += m["kl_loss"]
            sums["collapse"] += m["collapse_penalty"]
            sums["prop"] += m["prop_loss"]
        n = len(readbacks)
        if n == 0 and len(dataset) > 0:
            # No full batch fit the data axis (partial batches cannot split):
            # +inf for EVERY metric, not 0.0, since each is a --best_metric
            # candidate and a zero would win the is_best comparison.
            print(f"   ⚠️  {desc}: dataset has {len(dataset)} samples < "
                  f"batch_size {self.batch_size}; partial batches cannot "
                  "split over the data axis — metrics report +inf so they can "
                  "never be selected as best")
            return {k: float("inf") for k in sums}
        return {k: v / n if n else 0.0 for k, v in sums.items()}

    def _compute_true_train_loss(self, epoch: int,
                                 num_batches: int = 20) -> Dict[str, float]:
        """No-TF train loss on the first ``num_batches`` unshuffled batches
        (reference ``trainer.py:116-175``)."""
        beta = self.compute_beta(epoch)
        return self._eval_batches(self.dataset, beta, num_batches, "True loss")

    def _validate(self, val_dataset, beta: float) -> Dict[str, float]:
        return self._eval_batches(val_dataset, beta, None, "Validating")

    def _get_latent_stats(self) -> Dict[str, float]:
        """Latent stats + monitor-MI on one 64-row batch (reference
        ``trainer.py:524-575``); datasets smaller than 64 use one
        full-dataset batch instead of a partial one."""
        monitor_bs = min(64, len(self.dataset))
        if monitor_bs == 0:
            return {k: 0.0 for k in
                    ("mu_min", "mu_max", "mu_mean", "mu_std", "logvar_min",
                     "logvar_max", "logvar_mean", "logvar_std", "mutual_info")}
        molecules, conditions = next(iter(
            self.dataset.to_batches(monitor_bs, shuffle=False)))
        stats = monitor_step(self.params["encoder"], self.mcfg,
                             to_device(molecules, self.device),
                             to_device(conditions, self.device), mesh=self.mesh)
        stats = _Readback(stats).get()
        print(f"   Latent Stats: μ=[{stats['mu_min']:.3f}, {stats['mu_max']:.3f}] "
              f"(mean={stats['mu_mean']:.3f}, std={stats['mu_std']:.3f}), "
              f"logvar=[{stats['logvar_min']:.3f}, {stats['logvar_max']:.3f}] "
              f"(mean={stats['logvar_mean']:.3f}, std={stats['logvar_std']:.3f})")
        return stats

    # ---------------------------------------------------------- persistence

    def _snapshot(self):
        """Fresh full copies of every param and Adam-state leaf, made on the
        current stream, and an event recorded after them (None on the CPU):
        the next in-place step cannot touch the copies. Split leaves are
        gathered over the model group (a collective: every rank of the mesh
        calls this)."""
        if self.layouts is not None:
            params = pmesh.gather_params(self.mesh, self.params, self.layouts)
            opt_states = pmesh.gather_params(self.mesh, self.opt_states, self._opt_layouts())
        else:
            def copy(tree):
                return tree_map(lambda t: t.detach().clone(), tree)
            params, opt_states = copy(self.params), copy(self.opt_states)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return params, opt_states, event

    def _opt_layouts(self) -> dict:
        return {n: {"step": False, "m": lay, "v": lay} for n, lay in self.layouts.items()}

    def save_checkpoint(self, epoch: int, is_best: bool = False,
                        best_val_loss: float = float("inf")) -> None:
        """Write ``checkpoint_epoch_{epoch:03d}.npz`` (+ ``checkpoint_best``
        when ``is_best``, a byte copy of it).

        With ``TrainConfig.async_checkpoint`` (default) the host copy and
        the write run on a background thread while the next epoch trains,
        from a snapshot (:meth:`_snapshot`) whose event the thread waits on
        before it copies; the history lists are shallow-copied for the same
        reason. The snapshot doubles the device residency of params and
        states until the write lands; ``--sync_checkpoint`` trades that for
        a stall. At most one save is in flight (``join_saves``).

        On a mesh every rank calls this; rank 0 alone writes, full arrays
        (split leaves gathered over the model group, which is then the
        snapshot whatever ``async_checkpoint`` says).
        """
        self.join_saves()
        path = self.checkpoint_dir / f"checkpoint_epoch_{epoch:03d}.npz"
        data_stats = {
            "properties_mean": getattr(self.dataset, "properties_mean", None),
            "properties_std": getattr(self.dataset, "properties_std", None),
            "alphabet": self.alphabet,
        }
        params, opt_states, event = self.params, self.opt_states, None
        if self.layouts is not None:  # a collective over the model group
            params, opt_states, event = self._snapshot()
        if not self.is_writer:
            return
        if self.tcfg.async_checkpoint and self.layouts is None:
            params, opt_states, event = self._snapshot()
        history = {k: list(v) for k, v in self.history.items()}
        device = self.device

        def work():
            if event is not None:
                event.synchronize()
                # copy on a side stream: behind the snapshot only, not behind
                # the steps queued since on the main stream
                stream = torch.cuda.Stream(device)
                with torch.cuda.stream(stream):
                    host = ckpt_io.build_checkpoint_host(
                        epoch, params, opt_states, history, best_val_loss,
                        data_stats=data_stats)
            else:
                host = ckpt_io.build_checkpoint_host(
                    epoch, params, opt_states, history, best_val_loss,
                    data_stats=data_stats)
            ckpt_io.write_checkpoint(path, host)
            lines = []
            if is_best:
                best = self.checkpoint_dir / "checkpoint_best.npz"
                tmp = best.with_name(f"{best.name}.tmp.{os.getpid()}")
                try:
                    shutil.copyfile(path, tmp)
                    os.replace(tmp, best)
                finally:
                    tmp.unlink(missing_ok=True)
                lines.append(f"    Saved checkpoint: {best}")
            lines.append(f"    Saved checkpoint: {path}")
            print("\n".join(lines))

        if self.tcfg.async_checkpoint:
            t = threading.Thread(target=self._run_save, args=(work,),
                                 name=f"ckpt-save-epoch-{epoch}", daemon=True)
            self._save_thread = t
            t.start()
        else:
            work()

    def _run_save(self, work) -> None:
        try:
            work()
        except BaseException as e:  # surfaced at the next join point
            self._save_error = e

    def join_saves(self) -> None:
        """Block until any in-flight async checkpoint save has landed;
        re-raise a failed save's exception (a silently lost checkpoint must
        not look like a saved one)."""
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
        if self.mesh is not None:  # every rank past here sees rank 0's files
            import torch.distributed as dist
            dist.barrier(group=self.mesh.host_group)
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    def load_checkpoint(self, checkpoint_path) -> int:
        """Load params, Adam states and history from a checkpoint written by
        either package; returns its epoch."""
        self.join_saves()
        loaded = ckpt_io.load_checkpoint(checkpoint_path)
        params, opt_states = ckpt_io.train_state_from_checkpoint(loaded, self.device)
        if self.layouts is not None:  # re-shard the full arrays
            params = pmesh.shard_params(
                self.mesh, params, {n: self.layouts[n] for n in params})
            opt_states = pmesh.shard_params(
                self.mesh, opt_states, {n: self._opt_layouts()[n] for n in opt_states})
        # Keep predictor params if the checkpoint lacks them but we have them.
        self.params.update(params)
        self.opt_states.update(opt_states)
        if loaded["history"] is not None:
            self.history = loaded["history"]
        return loaded["epoch"]

    def save_history(self, path) -> None:
        if self.is_writer:
            save_history(self.history, path)

    def plot_history(self, save_path=None) -> None:
        if self.is_writer:
            plot_history(self.history, save_path)
