"""The port's train CLI on the CPU (``--device cpu``): its flag set against
the JAX CLI's, whole runs with checkpoints, history and ``--eval_test``,
``--resume`` across the two packages in both directions, the multi-device
refusal (checked before the corpus is loaded), the routes a model takes
where the fused kernels refuse it (none refused), and the compile-cache
flags, which every port CLI accepts and ignores."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mlx_vae_tpu.cli import generate as jgenerate
from mlx_vae_tpu.cli import serve as jserve
from mlx_vae_tpu.cli import train as jtrain
from mlx_vae_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from mlx_vae_tpu.train.history import HISTORY_KEYS
from mlx_vae_tpu_torch.cli import common as tcommon
from mlx_vae_tpu_torch.cli import generate as tgenerate
from mlx_vae_tpu_torch.cli import serve as tserve
from mlx_vae_tpu_torch.cli import train as ttrain
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.models import decoder as tdecoder

TINY = ["--vocab_size", "24", "--embedding_dim", "16", "--hidden_dim", "32",
        "--latent_dim", "8", "--num_layers", "2", "--batch_size", "32",
        "--learning_rate", "3e-3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the test runner's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "d.json"
    make_synthetic_dataset(n=300, vocab_size=24, max_length=12, path=str(path))
    return str(path)


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flag_set_equals_jax_plus_device():
    port, ref = _flags(ttrain.build_parser()), _flags(jtrain.build_parser())
    assert port.pop("device") == "cuda"
    assert port == ref
    assert len(ref) == 44  # the 42 training flags and the two cache flags


@pytest.mark.parametrize("module,jax_module", [(tgenerate, jgenerate), (tserve, jserve)])
def test_generation_cli_flag_sets_equal_jax_plus_device(module, jax_module):
    port, ref = _flags(module.build_parser()), _flags(jax_module.build_parser())
    assert port.pop("device") == "cuda"
    assert port == ref


def _train(tmp_path, data, *extra, ck="ck"):
    ttrain.main(["--data", data, *TINY, "--checkpoint_dir", str(tmp_path / ck),
                 "--device", "cpu", *extra])
    return tmp_path / ck


def _history(ck: Path) -> dict:
    return json.loads((ck / "training_history.json").read_text())


def test_two_epochs_checkpoints_history_and_eval_test(tmp_path, data, capsys):
    ck = _train(tmp_path, data, "--epochs", "2", "--checkpoint_freq", "1",
                "--eval_test", "--verbose", "--use_pallas")
    out = capsys.readouterr().out
    assert "Test set (30 samples)" in out and "Throughput" in out
    for name in ("checkpoint_epoch_000.npz", "checkpoint_epoch_001.npz",
                 "checkpoint_best.npz", "training_history.png"):
        assert (ck / name).exists(), name
    h = _history(ck)
    assert list(h) == HISTORY_KEYS and h["epoch"] == [0, 1]
    assert all(np.isfinite(v) for k in h for v in h[k])
    loaded = jax_load_checkpoint(ck / "checkpoint_epoch_001.npz")
    assert loaded["epoch"] == 1 and loaded["history"]["epoch"] == [0, 1]
    assert set(loaded["params"]) == {"encoder", "decoder"}
    assert loaded["data_stats"]["alphabet"] == json.loads(Path(data).read_text())["alphabet"]
    # a fresh run clears the old checkpoints and plot
    _train(tmp_path, data, "--epochs", "1", "--checkpoint_freq", "5")
    assert not (ck / "checkpoint_epoch_001.npz").exists()
    assert (ck / "checkpoint_best.npz").exists()


def test_synthetic_flag_writes_the_corpus(tmp_path):
    ttrain.main(["--data", str(tmp_path / "syn" / "s.json"), "--synthetic", "120", *TINY,
                 "--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck"),
                 "--device", "cpu", "--data_parallel"])  # one device: trains there
    doc = json.loads((tmp_path / "syn" / "s.json").read_text())
    assert len(doc["tokenized_sequences"]) == 120
    assert _history(tmp_path / "ck")["epoch"] == [0]


def test_resume_continues_from_best(tmp_path, data, capsys):
    ck = _train(tmp_path, data, "--epochs", "2", "--checkpoint_freq", "1")
    _train(tmp_path, data, "--epochs", "3", "--checkpoint_freq", "1", "--resume")
    assert "Resuming from epoch 2" in capsys.readouterr().out
    assert _history(ck)["epoch"] == [0, 1, 2]


def _jax_train(tmp_path, data, *extra, ck="ck"):
    jtrain.main(["--data", data, *TINY, "--checkpoint_dir", str(tmp_path / ck),
                 "--no_compilation_cache", *extra])
    return tmp_path / ck


def test_jax_checkpoint_resumes_in_the_port(tmp_path, data, capsys):
    ck = _jax_train(tmp_path, data, "--epochs", "1", "--use_property_predictor")
    jax_ck = jax_load_checkpoint(ck / "checkpoint_best.npz")
    _train(tmp_path, data, "--epochs", "2", "--use_property_predictor", "--resume")
    assert "Resuming from epoch 1" in capsys.readouterr().out
    h = _history(ck)
    assert h["epoch"] == [0, 1]
    assert h["train_loss"][0] == jax_ck["history"]["train_loss"][0]
    port_ck = jax_load_checkpoint(ck / "checkpoint_epoch_001.npz")
    assert set(port_ck["params"]) == {"encoder", "decoder", "predictor"}
    assert int(port_ck["opt_states"]["decoder"]["step"]) == \
        2 * int(jax_ck["opt_states"]["decoder"]["step"])  # 8 steps an epoch


def test_port_checkpoint_resumes_in_jax(tmp_path, data, capsys):
    ck = _train(tmp_path, data, "--epochs", "1")
    _jax_train(tmp_path, data, "--epochs", "2", "--resume")
    assert "Resuming from epoch 1" in capsys.readouterr().out
    assert _history(ck)["epoch"] == [0, 1]
    assert int(jax_load_checkpoint(ck / "checkpoint_epoch_001.npz")
               ["opt_states"]["encoder"]["step"]) == 16


def test_model_parallel_exits_before_loading(tmp_path, capsys):
    """One CPU device and no process group: --model_parallel 2 exits with
    the JAX trainer's message before the (missing) corpus is read."""
    with pytest.raises(SystemExit, match="model_parallel=2 requires at least 2 devices; "
                                         "1 visible"):
        ttrain.main(["--data", str(tmp_path / "missing.json"), *TINY, "--device", "cpu",
                     "--model_parallel", "2", "--use_pallas"])
    assert "disables --use_pallas" in capsys.readouterr().out


def test_route_refusal_on_the_card_only():
    """The model layer refuses no model on any device: a V=600 model, which
    the whole-stack kernels refuse, takes the sequence kernels in its
    encoder and the scan in its decoder, as the JAX package routes it. Only
    the dry run, which exists to launch the train kernels, refuses it, in
    the fused training decoder's own words."""
    from mlx_vae_tpu_torch.models.encoder import encoder_route
    from mlx_vae_tpu_torch.parallel.dryrun import kernel_route_refusal

    cfg = ModelConfig(vocab_size=600, use_pallas=True)
    for dev in (torch.device("cuda"), torch.device("cpu")):
        assert tdecoder.train_decoder_route(cfg, dev) == "scan"
    assert encoder_route(cfg) == "seq"
    reason = kernel_route_refusal(cfg)
    assert reason is not None and "vocab_size=600" in reason
    assert kernel_route_refusal(ModelConfig(use_pallas=True)) is None
    assert kernel_route_refusal(cfg.replace(use_pallas=False)) == "use_pallas is off"
    assert "reference_zero_state" in kernel_route_refusal(
        ModelConfig(use_pallas=True, reference_zero_state=True))


@pytest.mark.parametrize("kw,cuda,cpu", [
    (dict(use_pallas=True), "fused", "fused"),
    (dict(use_pallas=True, vocab_size=600), "scan", "scan"),
    (dict(), "scan", "scan"),
    (dict(use_pallas=True, reference_zero_state=True), "scan", "scan"),
    (dict(custom_vjp=True), "cv", "cv"),
    (dict(use_pallas=True, custom_vjp=True, vocab_size=600), "cv", "cv"),
    (dict(use_pallas=True, hidden_dim=1024, num_layers=4), "cvp", "cvp"),
    (dict(hidden_dim=1024, num_layers=4), "cv", "cv")])
def test_train_decoder_route(kw, cuda, cpu):
    """The route that the dispatch takes, by device: the same on both, the
    kernels' predicates asked before any launch."""
    cfg = ModelConfig(**kw)
    assert tdecoder.train_decoder_route(cfg, torch.device("cuda")) == cuda
    assert tdecoder.train_decoder_route(cfg, "cpu") == cpu


def test_refused_route_exits_before_loading(tmp_path, monkeypatch):
    """On a CUDA device ``--use_pallas`` with a model the fused kernels
    refuse (V=600) is no longer refused: the run makes and loads its corpus
    and goes on to build the model (stopped there: this machine has no
    card)."""
    from mlx_vae_tpu_torch.models import vae as tvae

    class Reached(Exception):
        pass

    def stop(*a, **kw):
        raise Reached

    monkeypatch.setattr(tcommon, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "a card")
    monkeypatch.setattr(tvae, "ARCVAE", stop)
    with pytest.raises(Reached):
        ttrain.main(["--data", str(tmp_path / "v.json"), "--synthetic", "50",
                     "--vocab_size", "600", "--use_pallas"])
    assert (tmp_path / "v.json").exists()


def test_refused_config_trains_on_the_scan_on_cpu(tmp_path, monkeypatch):
    """On CPU tensors the config the kernels refuse (V=600) trains with
    ``--use_pallas`` all the same: the decoder takes the scan."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    def refused(*a, **kw):
        raise AssertionError("the fused decoder ran")

    monkeypatch.setattr(fd, "decoder_train_ce", refused)
    monkeypatch.setattr(fd, "decoder_train", refused)
    ttrain.main(["--data", str(tmp_path / "v.json"), "--synthetic", "40",
                 "--vocab_size", "600", "--embedding_dim", "8", "--hidden_dim", "16",
                 "--latent_dim", "4", "--batch_size", "16", "--epochs", "1",
                 "--use_pallas", "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert np.isfinite(_history(tmp_path / "ck")["train_loss"][0])


def test_profile_writes_a_trace(tmp_path, data):
    _train(tmp_path, data, "--epochs", "1", "--batch_size", "128",
           "--profile", str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_step_timer_skips_warmup():
    from mlx_vae_tpu_torch.utils.profiler import StepTimer

    timer = StepTimer(warmup=2)
    assert timer.tokens_per_sec == 0.0
    for _ in range(5):
        timer.tick(100)
    assert timer.steps == 5 and timer.tokens == 300 and timer.tokens_per_sec > 0.0


@pytest.mark.parametrize("module", [ttrain, tgenerate, tserve])
def test_cache_flags_parse_and_change_nothing(module):
    base = ["--checkpoint", "ck.npz"] if module is not ttrain else []
    plain = vars(module.build_parser().parse_args(base))
    flagged = vars(module.build_parser().parse_args(
        base + ["--compilation_cache", "/nowhere", "--no_compilation_cache"]))
    assert {k for k in plain if plain[k] != flagged[k]} == {"compilation_cache",
                                                            "no_compilation_cache"}


def test_generate_with_data_and_cache_flags(tmp_path, data, capsys):
    """A port-trained checkpoint served by the port's generate CLI with
    ``--data``: novelty against the training split, SELFIES decoded with the
    dataset's alphabet; the cache flags leave the tokens unchanged."""
    ck = _train(tmp_path, data, "--epochs", "1")
    outs = []
    for extra in ([], ["--compilation_cache", str(tmp_path / "cc"),
                       "--no_compilation_cache"]):
        out = tmp_path / f"gen{len(extra)}.json"
        tgenerate.main(["--checkpoint", str(ck / "checkpoint_best.npz"), "--data", data,
                        "--device", "cpu", "--num_molecules", "40", "--batch_size", "16",
                        "--max_length", "12", "--target", "90", "--output", str(out),
                        *extra])
        outs.append(json.loads(out.read_text()))
    assert "Novelty vs training set" in capsys.readouterr().out
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert 0.0 <= outs[0]["novelty"] <= 1.0
    assert not (tmp_path / "cc").exists()
    alphabet = json.loads(Path(data).read_text())["alphabet"]
    from mlx_vae_tpu_torch.data.prepare import decode_tokens
    assert outs[0]["selfies"][0] == decode_tokens(outs[0]["tokens"][0], alphabet)
