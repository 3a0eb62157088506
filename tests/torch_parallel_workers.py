"""Rank workers for ``tests/test_torch_parallel.py``, in a module of their
own that imports no JAX: ``parallel/launch.py:spawn`` starts each rank from
a fresh interpreter, which imports this module to find the function."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def collectives(rank: int, device: str) -> dict:
    """all_reduce (sum, max) and broadcast of tensors on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    s = x.clone()
    dist.all_reduce(s)
    m = x.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    b = x.clone()
    dist.broadcast(b, src=0)
    return {"sum": s.cpu().numpy(), "max": m.cpu().numpy(), "bcast": b.cpu().numpy(),
            "backend": dist.get_backend()}


def _t(tree, device="cpu"):
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy
    return params_from_numpy(tree, device)


def _noise_t(n):
    out = {"eps": torch.from_numpy(n["eps"]), "tf_mask": torch.from_numpy(n["tf_mask"])}
    if "keep_masks" in n:
        out["keep_masks"] = [torch.from_numpy(m) for m in n["keep_masks"]]
    return out


def mesh_steps(rank: int, case: dict) -> dict:
    """Run ``case["mode"]`` steps of ``train/steps.py``'s mesh makers on a
    ``(len(ranks) / tp, tp)`` mesh (``case["ranks"]``, default all) over
    the case's global batches, with this
    rank's noise from ``case["noise"][data_rank]``; returns the metrics of
    every step and the full params (and Adam moments) after them."""
    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.parallel.mesh import (gather_params, make_mesh, param_layout,
                                                 shard_params)
    from mlx_vae_tpu_torch.train import steps
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.utils.tree import params_to_numpy

    mcfg, tcfg = ModelConfig(**case["model"]), TrainConfig(**case["train"])
    tp = case.get("tp", 1)
    mesh = make_mesh(tp, case.get("ranks"))
    if mesh is None:
        return None
    full = _t(case["params"])
    layouts = param_layout(full, tp)
    params = shard_params(mesh, full, layouts)
    opt = {n: adam_init(p) for n, p in params.items()}
    noise = case["noise"][mesh.data_rank]
    beta, tf = case["beta"], case["tf"]
    mode = case["mode"]
    metrics = []
    if mode == "train":
        step = steps.make_dp_train_step(mesh, mcfg, tcfg, layouts)
        for (x, c), nz in zip(case["batches"], noise):
            params, opt, m = step(params, opt, torch.from_numpy(x), torch.from_numpy(c), None,
                                  beta, tf, _noise_t(nz))
            metrics.append({k: float(v) for k, v in m.items()})
    elif mode in ("gather", "multi", "eval", "eval_gather"):
        toks, props = torch.from_numpy(case["tokens"]), torch.from_numpy(case["props"])
        idx = torch.from_numpy(case["idx"])
        if mode == "gather":
            step = steps.make_dp_train_step_gather(mesh, mcfg, tcfg, layouts)
            for k, nz in enumerate(noise):
                params, opt, m = step(params, opt, toks, props, idx[k], None, beta, tf,
                                      _noise_t(nz))
                metrics.append({k2: float(v) for k2, v in m.items()})
        elif mode == "multi":
            step = steps.make_dp_multi_train_step_gather(mesh, mcfg, tcfg, layouts)
            params, opt, m = step(params, opt, toks, props, idx, None, beta, tf,
                                  [_noise_t(nz) for nz in noise])
            metrics = [{k2: float(v[j]) for k2, v in m.items()} for j in range(idx.shape[0])]
        elif mode == "eval_gather":
            step = steps.make_dp_eval_step_gather(mesh, mcfg, tcfg)
            m = step(params, toks, props, idx[0], None, beta, tf, _noise_t(noise[0]))
            metrics.append({k2: float(v) for k2, v in m.items()})
        else:
            step = steps.make_dp_eval_step(mesh, mcfg, tcfg)
            m = step(params, toks[idx[0]].to(torch.int32), props[idx[0]], None, beta, tf,
                     _noise_t(noise[0]))
            metrics.append({k2: float(v) for k2, v in m.items()})
    opt_layouts = {n: {"step": False, "m": layouts[n], "v": layouts[n]} for n in layouts}
    return {"metrics": metrics,
            "params": params_to_numpy(gather_params(mesh, params, layouts)),
            "opt": params_to_numpy(gather_params(mesh, opt, opt_layouts)),
            "mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank)}


def cases(rank: int, all_cases: list) -> list:
    """:func:`mesh_steps` of each case in turn (None where this rank is
    outside the case's ranks)."""
    return [mesh_steps(rank, c) for c in all_cases]


def cli_runs(rank: int, runs: list) -> list:
    """Call each ``(module, argv)`` CLI's ``main`` in turn on this rank's
    process group; returns, for each, what it returned where that is
    numpy-friendly (encode's arrays; else None) and the paths this rank
    wrote through ``np.savez`` / ``np.savez_compressed``."""
    import importlib
    from unittest import mock

    out = []
    for module, argv in runs:
        saved = []

        def record(fn):
            return lambda path, *a, **k: (saved.append(str(path)), fn(path, *a, **k))[1]

        with mock.patch.object(np, "savez", record(np.savez)), \
                mock.patch.object(np, "savez_compressed", record(np.savez_compressed)):
            res = importlib.import_module(f"mlx_vae_tpu_torch.cli.{module}").main(argv)
        out.append(({k: v for k, v in res.items() if isinstance(v, np.ndarray)}
                    if isinstance(res, dict) else None, saved))
    return out


def fail_on_rank1(rank: int) -> None:
    """Rank 1 raises; rank 0 waits for it at a barrier that never comes."""
    if rank == 1:
        raise ValueError("rank 1 refuses")
    dist.barrier()


def sleep_forever(rank: int) -> None:
    import time
    time.sleep(3600)
