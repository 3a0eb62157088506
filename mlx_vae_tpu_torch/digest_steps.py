"""SHA-256s of the fused sampler's samples on the step route in bf16 (and,
asked, in f32 and on the tensor-core route), on one CUDA card; prints ONE
JSON line.

    python -m mlx_vae_tpu_torch.digest_steps [--batches 256,2048] [--f32] [--tc]

The step route (``ops/fused_decoder.py:fused_generate(..., kernel="steps")``,
``csrc/fused_generate_steps.cu``) at ``chip_smoke.py`` phase 19(a)'s bf16
configs: the scaled model (hidden 1024, 4 layers, latent 512), H=768 n=2
and the smallest H the route takes in bf16; at each batch, L=64, in phase
19(a)'s modes (greedy, T=0.8, top-k=6 / top-p=0.8 at T=0.8). ``--f32`` adds
phase 19(a)'s f32 configs on the step route (the scaled model, H=256 n=2
V=300, the smallest H in f32) and ``--tc`` the default model on the
tensor-core kernel in both dtypes (``kernel="tc"``): routes a change to the
bf16 step kernel must leave as they were. Each call's
tokens and first-step scaled logits are hashed, beside the hash of its
inputs (the prepared weights as every route holds them, h0, the
conditions, the seeds and temperatures), which are made on the card from
fixed seeds. The module
calls only functions an older tree has too (``prepare_weights``,
``hidden_init_row``, ``fused_generate``), so it also runs in the parent's
checkout (copy it there and run ``python -m`` from that root): equal
digests on equal inputs mean bitwise equal samples. The card's name and
power limit go to stderr; without CUDA the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

L = 64
SCALED = dict(hidden_dim=1024, num_layers=4, latent_dim=512)
MODES = (("greedy", 1.0, {"greedy": True}), ("T=0.8", 0.8, {}),
         ("top_k=6 top_p=0.8", 0.8, {"top_k": 6, "top_p": 0.8}))


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def smallest(dtype: str) -> int:
    """The smallest H from ``STEPS_MIN_H`` that the route sends to the step
    route in ``dtype`` (E=128, C=1, V=80, n=2)."""
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.ops.fused_decoder import STEPS_MIN_H, fused_generate_route

    H = STEPS_MIN_H[dtype]
    while fused_generate_route(ModelConfig(hidden_dim=H, compute_dtype=dtype)) != "steps":
        H += 1
    return H


def configs(f32: bool, tc: bool) -> list:
    """(name, dtype, widths, route) of the calls hashed (the docstring)."""
    out = [("scaled", "bfloat16", SCALED, "steps"),
           ("H=768 n=2", "bfloat16", dict(hidden_dim=768), "steps"),
           (f"H={smallest('bfloat16')} n=2", "bfloat16", dict(hidden_dim=smallest("bfloat16")),
            "steps")]
    if f32:
        out += [("scaled", "float32", SCALED, "steps"),
                ("H=256 n=2 V=300", "float32", dict(vocab_size=300), "steps"),
                (f"H={smallest('float32')} n=2", "float32",
                 dict(hidden_dim=smallest("float32")), "steps")]
    if tc:
        out += [("default", d, {}, "tc") for d in ("bfloat16", "float32")]
    return out


def digest(batches, f32: bool = False, tc: bool = False) -> dict:
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row, init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import block_rows, fused_generate, prepare_weights
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

    out = {}
    for name, dtype, widths, route in configs(f32, tc):
        cfg = ModelConfig(compute_dtype=dtype, **widths)
        params = params_from_numpy(params_to_numpy(
            init_decoder_params(torch.Generator().manual_seed(0), cfg)), "cuda")
        w = prepare_weights(params, cfg, "cuda", kernel=route)
        wsha = _sha([w.emb, w.wcat, w.bias, w.wout, w.bout])
        for B in batches:
            for mode, temp, kw in MODES:
                g = torch.Generator(device="cuda").manual_seed(7 + B)
                z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
                cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
                nb = -(-B // block_rows(B))
                seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device="cuda",
                                      dtype=torch.int32)
                temps = torch.full((nb,), temp, device="cuda")
                h0 = hidden_init_row(params, cfg, z, cond).contiguous()
                logits = torch.empty((B, cfg.vocab_size), device="cuda")
                toks = fused_generate(w, h0, cond, seeds, temps, L, logits_out=logits,
                                      kernel=route, **kw)
                torch.cuda.synchronize()
                out[f"{name} {dtype} {route} B={B} {mode}"] = {
                    "inputs": _sha([h0, cond, seeds, temps]) + "/" + wsha,
                    "tokens": _sha([toks]), "logits": _sha([logits])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="256,2048")
    ap.add_argument("--f32", action="store_true", help="also the f32 step route's configs")
    ap.add_argument("--tc", action="store_true", help="also the default model on the tc route")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("digest_steps: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          file=sys.stderr)
    print(json.dumps({"digest_steps": digest([int(b) for b in args.batches.split(",")],
                                             args.f32, args.tc)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
