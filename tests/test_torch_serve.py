"""The port's HTTP server and bulk CLI on the CPU (``--device cpu``, the
fused sampler's plain version): a subset mirroring ``tests/test_serve.py``
plus the port's own flags."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mlx_vae_tpu.cli import serve as jserve
from mlx_vae_tpu_torch.cli import serve as tserve
from mlx_vae_tpu_torch.cli.generate import main as generate_main
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import init_decoder_params
from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

MCFG = ModelConfig(vocab_size=24, embedding_dim=16, hidden_dim=16,
                   latent_dim=8, num_conditions=2, num_layers=1)
STATS = {"properties_mean": [60.0, 2.0], "properties_std": [25.0, 1.0],
         "alphabet": ["[C]", "[N]", "[O]"]}


def _checkpoint(path, seed=0, stats=STATS, cfg=MCFG):
    dec = init_decoder_params(torch.Generator().manual_seed(seed), cfg)
    write_checkpoint(path, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {},
        data_stats=stats))
    return str(path)


def _start(argv):
    args = tserve.build_parser().parse_args(argv)
    ready = threading.Event()
    thread = threading.Thread(target=tserve.serve_forever, args=(args, ready),
                              daemon=True)
    thread.start()
    assert ready.wait(timeout=120), "server did not come up"
    return ready, thread, f"http://127.0.0.1:{ready.server.server_address[1]}"


@pytest.fixture(scope="module")
def _srv(tmp_path_factory):
    ck = _checkpoint(tmp_path_factory.mktemp("tserve") / "ck.npz")
    ready, thread, base = _start([
        "--checkpoint", ck, "--port", "0", "--batch_sizes", "8,32",
        "--max_length", "12", "--device", "cpu",
        "--truncation", "top_k=3", "--truncation", "top_k=6,top_p=0.8"])
    assert ready.service.wait_warm(timeout=120), "warm-up stalled"
    yield base, ready.service
    ready.server.shutdown()
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def server(_srv):
    return _srv[0]


@pytest.fixture(scope="module")
def service(_srv):
    return _srv[1]


def _post(base, payload, path="/generate"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_health(server, service):
    """The fused sampler (its plain version here) coalesces every config in
    blocks of 32 rows, the largest tier's seed block; /health says so, and
    after ``wait_warm`` the whole ladder is warm without error."""
    assert service.wait_warm(timeout=120)
    code, h = _get(server, "/health")
    assert code == 200 and h["status"] == "ok"
    assert h["model"]["latent_dim"] == 8
    assert h["batch_size"] == 32 and h["batch_tiers"] == [8, 32]
    assert h["coalescing"] == {"stochastic": True, "greedy": True,
                               "truncated": {"top_k=3,top_p=1.0": True,
                                             "top_k=6,top_p=0.8": True},
                               "block_rows": 32}
    assert h["truncation_configs"] == [[3, 1.0], [6, 0.8]]
    assert h["warmup"]["complete"] and h["warmup"]["warm_programs"] == 8
    assert h["warmup"]["total_programs"] == 8 and h["warmup"]["error"] is None
    assert h["backend"] == "cpu" and h["alphabet_size"] == 3
    assert h["kernel_launches"] >= 0


def test_health_names_the_sampler(server):
    """The served model takes the fused sampler (its plain version on the
    CPU); /health says so."""
    _, h = _get(server, "/health")
    assert h["sampler"] == "fused"
    assert h["sampler_route"] == "tc"  # H=16: a cluster size fits


def test_refused_model_is_served_by_the_scan_sampler(tmp_path, capsys):
    """V = 600: the fused sampler refuses the model, so the server and the
    bulk CLI route it to the scan sampler, as the JAX CLIs do, instead of
    raising; no kernel weights are prepared and nothing is launched."""
    ck = _checkpoint(tmp_path / "ck.npz", stats=None, cfg=MCFG.replace(vocab_size=600))
    args = tserve.build_parser().parse_args([
        "--checkpoint", ck, "--port", "0", "--batch_size", "8", "--max_length", "8",
        "--no_normalize", "--device", "cpu"])
    before = fused_generate.launches
    svc = tserve.GenerationService(args)
    try:
        assert svc.health()["sampler"] == "scan" and svc.weights is None
        assert svc.health()["sampler_route"] is None
        req = {"num_molecules": 5, "target": [0.0, 0.0], "seed": 2, "return_tokens": True}
        a, b = svc.generate(req), svc.generate(req)
        toks = np.asarray(a["tokens"])
        assert toks.shape == (5, 8) and toks.min() >= 0 and toks.max() < 600
        assert a["tokens"] == b["tokens"]
    finally:
        svc.close()
    generate_main(["--checkpoint", ck, "--device", "cpu", "--num_molecules", "10",
                   "--batch_size", "8", "--max_length", "6", "--no_normalize",
                   "--target", "0", "0", "--output", str(tmp_path / "gen.json")])
    assert "scan sampler" in capsys.readouterr().out
    assert np.asarray(json.loads((tmp_path / "gen.json").read_text())["tokens"]).shape == (10, 6)
    assert fused_generate.launches == before


def test_generate_pads_and_loops_tiers(server):
    """48 molecules over tiers [8, 32]: 32 + 8 + 8 rows, trimmed to 48."""
    code, g = _post(server, {"num_molecules": 48, "target": [90.0, 2.5],
                             "temperature": 0.8, "seed": 3, "return_tokens": True})
    assert code == 200
    toks = np.asarray(g["tokens"])
    assert toks.shape == (48, 12) and toks.min() >= 0 and toks.max() < 24
    assert g["passes"] == 3 and g["coalesced"] is False
    assert 0.0 <= g["validity"] <= 1.0 and 0.0 < g["uniqueness"] <= 1.0
    assert len(g["selfies"]) == 48 and g["mols_per_sec"] > 0


def test_same_seed_is_deterministic(server):
    req = {"num_molecules": 16, "target": [60.0, 1.0], "seed": 7, "return_tokens": True}
    _, a = _post(server, req)
    _, b = _post(server, req)
    assert a["tokens"] == b["tokens"]
    _, c = _post(server, {**req, "seed": 8})
    assert c["tokens"] != a["tokens"]


def test_greedy_flag(server):
    req = {"num_molecules": 8, "target": [60.0, 1.0], "seed": 1,
           "greedy": True, "return_tokens": True}
    _, a = _post(server, req)
    _, b = _post(server, {**req, "greedy": False})
    assert a["greedy"] and not b["greedy"]
    assert a["tokens"] != b["tokens"]


def test_truncated_configs(server):
    req = {"num_molecules": 6, "target": [0.0, 0.0], "seed": 9, "top_k": 3,
           "return_tokens": True}
    _, a = _post(server, req)
    _, b = _post(server, req)
    assert a["tokens"] == b["tokens"] and (a["top_k"], a["top_p"]) == (3, 1.0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {**req, "top_k": 4})
    assert e.value.code == 400
    assert "--truncation" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("bad", [
    {"num_molecules": 0}, {"num_molecules": "many"}, {"num_molecules": True},
    {"temperature": -1.0}, {"top_k": 5}, {"target": [90.0]}, {"seed": 1.5},
    {"top_k": 3.5}, {"max_selfies": -5}, {"max_selfies": 2.5},
    {"top_k": 3, "greedy": True}, {"target": 90}, {"seed": None},
    {"temperature": [1]}, {"target": [None, None]}, {"num_molecules": 10_000_001},
])
def test_bad_requests_get_400(server, bad):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, bad)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_unknown_paths_404(server):
    for call in (lambda: _get(server, "/nope"), lambda: _post(server, {}, "/nope")):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == 404


def test_tier_routing_minimizes_rows(service):
    assert service.plan_passes(48) == [32, 8, 8]
    assert service.plan_passes(4) == [8]
    assert service.plan_passes(33) == [32, 8]
    assert service.plan_passes(64) == [32, 32]


@pytest.mark.parametrize("tiers", [(8, 32), (256, 2048, 8192), (8, 12), (8, 32, 128)])
def test_plan_cover_equals_jax(tiers):
    for n in list(range(1, 300, 7)) + [4100, 8192, 10000, 16385]:
        assert tserve.plan_cover(n, tiers) == jserve.plan_cover(n, tiers)


def test_parse_truncation():
    assert tserve.parse_truncation("top_k=6,top_p=0.8") == (6, 0.8)
    for bad in ("", "top_k=0", "top_p=1.0", "top_k=-1", "top_q=3", "top_k=x"):
        with pytest.raises(SystemExit):
            tserve.parse_truncation(bad)


@pytest.mark.parametrize("exc", [ValueError, RuntimeError])
def test_dispatcher_error_is_json_500(server, service, exc):
    orig_solo, orig_co = service._run_solo, service._run_coalesced

    def boom(*a, **k):
        raise exc("bad shapes inside the device pass")

    service._run_solo = service._run_coalesced = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"num_molecules": 3, "target": [60.0, 1.0]})
        assert e.value.code == 500
        assert exc.__name__ in json.loads(e.value.read())["error"]
    finally:
        service._run_solo, service._run_coalesced = orig_solo, orig_co


def test_cold_sampler_config_is_503(server, service):
    saved = set(service._warm)
    service._warm = set()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"num_molecules": 3, "target": [60.0, 1.0]})
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "60"
    finally:
        service._warm = saved


def test_calibrated_request_equals_raw_request(service):
    a, b, t = 3.0, 0.5, 90.0
    raw = service.generate({"num_molecules": 4, "greedy": True, "seed": 7,
                            "target": [(t - a) / b, 0.0], "return_tokens": True})
    service.calib = (a, b)
    try:
        cal = service.generate({"num_molecules": 4, "greedy": True, "seed": 7,
                                "target": [t, 0.0], "return_tokens": True})
    finally:
        service.calib = None
    assert cal["calibrated_request"] == pytest.approx((t - a) / b, abs=0.01)
    assert cal["tokens"] == raw["tokens"] and cal["target"] == [t, 0.0]


def test_service_close_stops_dispatcher(tmp_path):
    args = tserve.build_parser().parse_args([
        "--checkpoint", _checkpoint(tmp_path / "ck.npz", stats=None), "--port", "0",
        "--batch_size", "8", "--max_length", "8", "--no_normalize", "--device", "cpu",
        "--sync_warmup"])
    svc = tserve.GenerationService(args)
    assert svc.generate({"num_molecules": 2, "target": [0.0, 0.0],
                         "return_tokens": True})["num_molecules"] == 2
    assert "selfies" not in svc.generate({"num_molecules": 1, "target": [0.0, 0.0]})
    svc.close()
    assert not svc._dispatcher.is_alive()
    with pytest.raises(tserve._DispatchError, match="service closed"):
        svc.generate({"num_molecules": 1, "target": [0.0, 0.0]})
    svc.close()  # idempotent


@pytest.mark.parametrize("flags,match", [
    (["--batch_sizes", "256,,2048"], "batch_sizes"),
    (["--batch_sizes", "x"], "batch_sizes"),
    (["--calibrate_response", "1,0"], "calibrate_response"),
    (["--calibrate_response", "a,b"], "calibrate_response"),
    (["--truncation", "top_q=1"], "truncation"),
])
def test_bad_flags_are_clean_exits(flags, match):
    args = tserve.build_parser().parse_args(["--checkpoint", "unused.npz", *flags])
    with pytest.raises(SystemExit, match=match):
        tserve.GenerationService(args)


def test_cuda_device_without_cuda_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tserve.build_parser().parse_args(
        ["--checkpoint", _checkpoint(tmp_path / "ck.npz")])  # --device defaults to cuda
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tserve.GenerationService(args)


def test_data_flag_gives_train_split_stats(tmp_path):
    """``--data`` exited as not yet ported until the corpus feed was ported;
    now a missing file is an error and a dataset gives the train split's
    stats and alphabet, as in the JAX server."""
    from mlx_vae_tpu.cli.common import resolve_property_stats as jax_resolve
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset

    ck = _checkpoint(tmp_path / "ck.npz")
    args = tserve.build_parser().parse_args([
        "--checkpoint", ck, "--device", "cpu", "--data", str(tmp_path / "train.json")])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tserve.GenerationService(args)
    make_synthetic_dataset(n=60, vocab_size=24, max_length=12,
                           path=str(tmp_path / "train.json"))
    svc = tserve.GenerationService(tserve.build_parser().parse_args([
        "--checkpoint", ck, "--device", "cpu", "--data", str(tmp_path / "train.json"),
        "--batch_sizes", "8", "--max_length", "12"]))
    try:
        mean, std, alphabet, _ = jax_resolve(str(tmp_path / "train.json"), False, {},
                                             MCFG.num_conditions)
        np.testing.assert_array_equal(svc.mean, mean)
        np.testing.assert_array_equal(svc.std, std)
        assert svc.alphabet == alphabet and svc.alphabet != STATS["alphabet"]
    finally:
        svc.close()


@pytest.mark.parametrize("suffix", ["json", "npz"])
def test_generate_cli_on_cpu(tmp_path, suffix, capsys):
    ck = _checkpoint(tmp_path / "ck.npz")
    out = tmp_path / f"gen.{suffix}"
    generate_main(["--checkpoint", ck, "--device", "cpu", "--num_molecules", "50",
                   "--batch_size", "16", "--max_length", "10", "--target", "90", "2",
                   "--temperature", "0.8", "--calibrate_response", "2.0,0.5",
                   "--output", str(out)])
    text = capsys.readouterr().out
    assert "Calibrated conditioning" in text and "Uniqueness" in text
    if suffix == "json":
        doc = json.loads(out.read_text())
        toks = np.asarray(doc["tokens"])
        assert len(doc["selfies"]) == 50
    else:
        doc = np.load(out)
        toks = doc["tokens"]
        assert toks.dtype == np.uint8
    assert toks.shape == (50, 10) and 0 < float(doc["uniqueness"]) <= 1


def test_generate_cli_data_parallel_not_yet_ported(tmp_path):
    """--data_parallel on one device (no process group, no card) generates
    there, as the JAX CLI does when it forms no mesh: the same tokens as
    without the flag."""
    argv = ["--checkpoint", _checkpoint(tmp_path / "ck.npz"), "--device", "cpu",
            "--num_molecules", "10", "--batch_size", "4", "--max_length", "6", "--greedy",
            "--target", "60", "1"]
    generate_main(argv + ["--output", str(tmp_path / "a.npz")])
    generate_main(argv + ["--output", str(tmp_path / "b.npz"), "--data_parallel"])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npz")["tokens"],
                                  np.load(tmp_path / "a.npz")["tokens"])
