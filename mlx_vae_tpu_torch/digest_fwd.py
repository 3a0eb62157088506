"""SHA-256s of the train forwards that run the forward step kernels, on one
CUDA card; prints ONE JSON line.

    python -m mlx_vae_tpu_torch.digest_fwd [--dtypes float32,bfloat16]

``csrc/train_common.cuh``'s ``seq_fwd_step_kernel`` (bf16) and
``seq_fwd_tf32_kernel`` (f32) run rows 2, 4, 6 and 7 of the kernel table:
the whole-stack encoder's forward (``ops/fused_encoder.py:encoder_fwd``),
the training decoder's forward with CE and with logits
(``ops/fused_train_decoder.py:decoder_fwd``, teacher forcing 0.9) at the
default model and phase 6's batches (``chip_smoke.py:TRAIN_BATCHES``), and
the sequence LSTM's forward (``ops/fused_seq_lstm.py:seq_lstm_fwd``) at
phase 9's shapes (I = 128, 129 and 1024, H = 1024, B = 2048). Each output
tuple is hashed with its inputs' hash beside it; the inputs are made on the
card from fixed seeds. The functions it calls have kept their signatures,
so the file runs in an older checkout too: run it there (``python -m`` from
that checkout's root) and here; equal digests on equal inputs mean bitwise
equal outputs. The card's name and power limit go to stderr; without CUDA
the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

L = 64
BATCHES = (4096, 2053, 2052, 1000, 64, 34)  # chip_smoke.py:TRAIN_BATCHES
SEQ_SHAPES = ((128, 1024), (129, 1024), (1024, 1024))  # (I, H) at B = 2048
SEQ_B = 2048


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digest(dtype: str) -> dict:
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fdec
    from mlx_vae_tpu_torch.ops import train_common as tc

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True)
    params = init_train_params(cfg, "cuda", 0)
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    out = {}
    for Bn in BATCHES:
        g = torch.Generator(device="cuda").manual_seed(Bn)
        tok = torch.randint(0, cfg.vocab_size, (Bn, L), generator=g, device="cuda",
                            dtype=torch.int32)
        cond = torch.randn((Bn, cfg.num_conditions), generator=g, device="cuda")
        h0 = 0.5 * torch.randn((Bn, cfg.hidden_dim), generator=g, device="cuda")
        tf = torch.rand((L,), generator=g, device="cuda") < 0.9
        out[f"encoder B={Bn}"] = {"inputs": _sha([we.wcat, tok]),
                                  "outputs": _sha(fe.encoder_fwd(we, tok))}
        for with_ce in (True, False):
            res = fdec.decoder_fwd(wd, h0, cond, tok, tf, with_ce)
            out[f"decoder B={Bn} {'ce' if with_ce else 'logits'}"] = {
                "inputs": _sha([wd.wcat, wd.woutT, tok, cond, h0, tf]), "outputs": _sha(res)}
    wdt = cfg.dtype
    for I, H in SEQ_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(I)
        wcat = (0.05 * torch.randn((I + H, 4 * H), generator=g, device="cuda")).to(wdt)
        bias = 0.1 * torch.randn((4 * H,), generator=g, device="cuda")
        xs = torch.randn((L, SEQ_B, I), generator=g, device="cuda").to(wdt)
        h0 = 0.5 * torch.randn((SEQ_B, H), generator=g, device="cuda")
        c0 = 0.5 * torch.randn((SEQ_B, H), generator=g, device="cuda")
        res = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
        out[f"seq I={I} H={H} B={SEQ_B}"] = {"inputs": _sha([wcat, bias, xs, h0, c0]),
                                             "outputs": _sha(res)}
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("digest_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          file=sys.stderr)
    print(json.dumps({"digest_fwd": {d: digest(d) for d in args.dtypes.split(",")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
