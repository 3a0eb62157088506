"""Plain PyTorch reference of the AR-CVAE (family ``arcvae``), written from
the model's equations; it imports nothing of the measured program.

The model (the MLX reference, github.com/Raiden-Makoto/MLX-VAE):

* encoder: token embedding -> ``num_layers`` stacked unidirectional LSTMs
  (gates i, f, g, o; ``c' = sig(f) c + sig(i) tanh(g)``, ``h' = sig(o)
  tanh(c')``) -> the last step's h, concatenated with ``condition_fc(cond)``
  -> ``mu = 2 tanh(fc_mu / 2)`` and ``logvar = tanh(fc_logvar(tanh(
  fc_logvar_hidden)) / 2) - 1``; ``z = mu + eps exp(logvar / 2)``;
* decoder: every layer starts from ``h = (z_to_hidden(z) +
  condition_to_hidden(cond)) / 2``, ``c = 0``; step t feeds ``[emb(token),
  cond]`` (token 0 first), the top h through ``fc_out`` gives the logits; in
  training the next token is the target where ``tf_mask[t]``, else the
  argmax;
* loss: mean token cross-entropy + beta KL (mu clipped to [-3, 3], logvar to
  [-6, 3], per-dimension floor ``free_bits / latent``) + the collapse
  penalty ``lambda_collapse max(0, target_mi - MI)`` + ``lambda_mi max(0,
  target_mi - MI)``, MI the moment-matched estimate; no property head;
* update: one global-norm clip over every leaf, then Adam without bias
  correction (``p -= lr m / (sqrt(v) + eps)``).

Parameters keep the measured program's tree layout (``weight [out, in]``,
LSTM ``Wx [4H, in]``, ``Wh [4H, H]``, ``bias [4H]``) so the same tensors go
to both. :func:`make_params` draws them on the device from a seed, in two
large calls, with the reference's init scales.

Run in float32 with TF32 off (the caller sets the backends), this is the
comparison's reference; with TF32 on, its control.
"""

from __future__ import annotations

import hashlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.noise import gumbel_noise

START, END, PAD = 0, 2, 0  # the decoder's first input, the end token, the pad token


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


def model_shape(cfg: dict) -> tuple:
    return (cfg["vocab_size"], cfg["embedding_dim"], cfg["hidden_dim"], cfg["latent_dim"],
            cfg["num_conditions"], cfg["num_layers"])


def leaf_specs(cfg: dict, parts=("encoder", "decoder")) -> list:
    """``[(part, key, name, shape, init, scale)]`` in tree order; ``init`` is
    ``"uniform"`` (U(-scale, scale)), ``"normal"`` (N(0, 1) scale) or
    ``"const"``."""
    V, E, H, Z, C, n = model_shape(cfg)
    out = []

    def linear(part, key, i, o):
        k = 1.0 / math.sqrt(i)
        out.append((part, key, "weight", (o, i), "uniform", k))
        out.append((part, key, "bias", (o,), "uniform", k))

    def lstm(part, key, i):
        k = 1.0 / math.sqrt(H)
        out.append((part, key, "Wx", (4 * H, i), "uniform", k))
        out.append((part, key, "Wh", (4 * H, H), "uniform", k))
        out.append((part, key, "bias", (4 * H,), "uniform", k))

    if "encoder" in parts:
        out.append(("encoder", "embedding", "weight", (V, E), "normal", E ** -0.5))
        for i in range(n):
            lstm("encoder", f"lstm_layer_{i}", E if i == 0 else H)
        linear("encoder", "condition_fc", C, H)
        linear("encoder", "fc_mu", 2 * H, Z)
        linear("encoder", "fc_logvar_hidden", 2 * H, 2 * H)
        k = 1.0 / math.sqrt(2 * H)
        out.append(("encoder", "fc_logvar", "weight", (Z, 2 * H), "uniform", k))
        out.append(("encoder", "fc_logvar", "bias", (Z,), "const", 0.35))
    if "decoder" in parts:
        linear("decoder", "z_to_hidden", Z, H)
        linear("decoder", "condition_to_hidden", C, H)
        out.append(("decoder", "embedding", "weight", (V, E), "normal", E ** -0.5))
        for i in range(n):
            lstm("decoder", f"lstm_layer_{i}", E + C if i == 0 else H)
        linear("decoder", "fc_out", H, V)
    return out


def make_params(cfg: dict, seed: int, device, parts=("encoder", "decoder")) -> dict:
    """The parameter tree ``{part: {key: {name: tensor}}}``, f32, on
    ``device``, drawn from ``seed`` in one uniform and one normal call."""
    specs = leaf_specs(cfg, parts)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "params"))
    sizes = {kind: sum(math.prod(s[3]) for s in specs if s[4] == kind)
             for kind in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0,
            "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    offs = {"uniform": 0, "normal": 0}
    tree: dict = {}
    for part, key, name, shape, init, scale in specs:
        numel = math.prod(shape)
        if init == "const":
            leaf = torch.full(shape, scale, dtype=torch.float32, device=device)
        else:
            leaf = (flat[init][offs[init]:offs[init] + numel] * scale).view(shape).clone()
            offs[init] += numel
        tree.setdefault(part, {}).setdefault(key, {})[name] = leaf
    return tree


def leaves(tree: dict) -> list:
    """``[(path, tensor)]`` in tree order."""
    out = []
    for part, keys in tree.items():
        for key, names in keys.items():
            for name, t in names.items():
                out.append((f"{part}.{key}.{name}", t))
    return out


def _cell(g: torch.Tensor, c: torch.Tensor, H: int):
    i, f, gg, o = (g[:, k * H:(k + 1) * H] for k in range(4))
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"].T + p["bias"]


def _saved(fn, *args):
    """``fn(*args)``; under autograd its intermediates are recomputed in the
    backward rather than kept, so the reference fits beside the timed
    sizes' activations."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(enc: dict, cfg: dict, x: torch.Tensor, cond: torch.Tensor):
    """``x [B, L]`` tokens, ``cond [B, C]`` -> ``(mu, logvar)``."""
    H, n = cfg["hidden_dim"], cfg["num_layers"]
    seq = enc["embedding"]["weight"][x.long()]
    B, L = x.shape
    for layer in range(n):
        p = enc[f"lstm_layer_{layer}"]
        xw = seq @ p["Wx"].T + p["bias"]
        h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        outs = []
        for t in range(L):
            h, c = _saved(lambda a, h_, c_, w=p["Wh"]: _cell(a + h_ @ w.T, c_, H), xw[:, t], h, c)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
    combined = torch.cat([seq[:, -1], _linear(enc["condition_fc"], cond)], dim=1)
    mu = 2.0 * torch.tanh(_linear(enc["fc_mu"], combined) / 2.0)
    hid = torch.tanh(_linear(enc["fc_logvar_hidden"], combined))
    logvar = torch.tanh(_linear(enc["fc_logvar"], hid) / 2.0) - 1.0
    return mu, logvar


def decoder_init(dec: dict, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Every layer's initial h ``[B, H]``."""
    return (_linear(dec["z_to_hidden"], z) + _linear(dec["condition_to_hidden"], cond)) / 2.0


def decode_step(dec: dict, cfg: dict, token: torch.Tensor, cond: torch.Tensor,
                hs: list, cs: list):
    """One decoder step from the fed ``token [B]``: the logits ``[B, V]``;
    ``hs`` / ``cs`` (per layer) are replaced in place."""
    H = cfg["hidden_dim"]
    x = torch.cat([dec["embedding"]["weight"][token.long()], cond], dim=1)
    for layer in range(cfg["num_layers"]):
        p = dec[f"lstm_layer_{layer}"]
        hs[layer], cs[layer] = _cell(x @ p["Wx"].T + hs[layer] @ p["Wh"].T + p["bias"],
                                     cs[layer], H)
        x = hs[layer]
    return _linear(dec["fc_out"], x)


def decode_teacher_forced(dec: dict, cfg: dict, z, cond, targets, tf_mask):
    """Logits ``[B, L, V]``; the token after step t is ``targets[:, t]``
    where ``tf_mask[t]``, else step t's argmax."""
    B, L = targets.shape
    h0 = decoder_init(dec, z, cond)
    hs = [h0] * cfg["num_layers"]
    cs = [torch.zeros_like(h0)] * cfg["num_layers"]
    token = torch.full((B,), START, dtype=torch.long, device=z.device)
    out = []
    n = cfg["num_layers"]

    def step(token, *state):
        hs_, cs_ = list(state[:n]), list(state[n:])
        logits = decode_step(dec, cfg, token, cond, hs_, cs_)
        return (logits, *hs_, *cs_)

    for t in range(L):
        logits, *state = _saved(step, token, *hs, *cs)
        hs, cs = state[:n], state[n:]
        out.append(logits)
        token = torch.where(tf_mask[t], targets[:, t].long(), logits.detach().argmax(dim=1))
    return torch.stack(out, dim=1)


def _mutual_information(mu, logvar):
    mu = mu.clamp(-3.0, 3.0)
    logvar = logvar.clamp(-6.0, 3.0)
    var = logvar.exp()
    mean_kl = (-0.5 * (1.0 + logvar - mu.square() - var).sum(dim=1)).mean()
    mean_var = var.mean(dim=0)
    agg_kl = -0.5 * (1.0 + mean_var.log() - mu.mean(dim=0).square() - mean_var).sum()
    return (mean_kl - agg_kl).clamp_min(0.0)


def losses(params: dict, cfg: dict, tcfg: dict, x, cond, eps, tf_mask, beta) -> dict:
    """The five loss components and their total (``prop_loss`` is 0: no
    property head)."""
    enc, dec = params["encoder"], params["decoder"]
    mu, logvar = encode(enc, cfg, x, cond)
    z = mu + eps * torch.exp(0.5 * logvar)
    logits = decode_teacher_forced(dec, cfg, z, cond, x, tf_mask)
    V = logits.shape[-1]
    recon = torch.nn.functional.cross_entropy(logits.reshape(-1, V), x.reshape(-1).long())
    Z = mu.shape[1]
    mu_c, lv_c = mu.clamp(-3.0, 3.0), logvar.clamp(-6.0, 3.0)
    kl_dim = (-0.5 * (1.0 + lv_c - mu_c.square() - lv_c.exp())).clamp_min(0.0)
    if tcfg["free_bits"] > 0:
        kl_dim = kl_dim.clamp_min(tcfg["free_bits"] / Z)
    kl = kl_dim.sum(dim=1).mean()
    mi = _mutual_information(mu, logvar)
    short = (tcfg["target_mi"] - mi).clamp_min(0.0)
    collapse = tcfg["lambda_collapse"] * short
    mi_penalty = tcfg["lambda_mi"] * short
    prop = torch.zeros((), dtype=torch.float32, device=x.device)
    total = recon + beta * kl + collapse + tcfg["lambda_prop"] * prop + mi_penalty
    return {"total_loss": total, "recon_loss": recon, "kl_loss": kl,
            "collapse_penalty": collapse, "prop_loss": prop, "mi_penalty": mi_penalty}


def adam_state(params: dict) -> dict:
    return {path: (torch.zeros_like(t), torch.zeros_like(t)) for path, t in leaves(params)}


def train_step(params: dict, state: dict, cfg: dict, tcfg: dict, x, cond, eps, tf_mask,
               beta) -> tuple:
    """One step in place on ``params`` and ``state``. Returns ``(loss
    values {name: float}, clipped gradients {path: tensor})``."""
    flat = leaves(params)
    for _, t in flat:
        t.requires_grad_(True)
    ls = losses(params, cfg, tcfg, x, cond, eps, tf_mask, beta)
    grads = torch.autograd.grad(ls["total_loss"], [t for _, t in flat], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, (_, t) in zip(grads, flat)]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    clip = tcfg["grad_clip"]
    scale = torch.where(norm > clip, clip / (norm + 1e-8), torch.ones_like(norm))
    grads = [g * scale for g in grads]
    b1, b2, eps_a, lr = tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"], tcfg["learning_rate"]
    with torch.no_grad():
        for (path, p), g in zip(flat, grads):
            p.requires_grad_(False)
            m, v = state[path]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            p.sub_(lr * m / (torch.sqrt(v) + eps_a))
    return ({k: float(v.detach()) for k, v in ls.items()},
            {path: g.detach() for (path, _), g in zip(flat, grads)})


@torch.no_grad()
def perturbed_logits(dec: dict, cfg: dict, z, cond, tokens, seeds, temperature: float):
    """The sampler's scores along served ``tokens [B, L]``: at step t the
    decoder fed the served token of step t - 1 (token 0 first) gives
    logits; returns ``logits / T + Gumbel noise`` ``[B, L, V]`` with the
    noise of the block seeds ``seeds`` (``min(256, B)`` rows a block), or
    ``logits / T`` for a greedy request (``seeds`` None)."""
    B, L = tokens.shape
    V = cfg["vocab_size"]
    rows = torch.arange(B, device=z.device)
    br = min(256, B)
    if seeds is not None:
        seed_row, in_block = seeds[rows // br], rows % br
    h0 = decoder_init(dec, z, cond)
    hs = [h0] * cfg["num_layers"]
    cs = [torch.zeros_like(h0)] * cfg["num_layers"]
    token = torch.full((B,), START, dtype=torch.long, device=z.device)
    out = torch.empty((B, L, V), dtype=torch.float32, device=z.device)
    for t in range(L):
        logits = decode_step(dec, cfg, token, cond, hs, cs)
        out[:, t] = logits / max(temperature, 1e-6)
        if seeds is not None:
            out[:, t] += gumbel_noise(seed_row, in_block, t, V)
        token = tokens[:, t].long()
    return out
