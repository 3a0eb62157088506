"""Port samplers vs the JAX package, on the CPU.

* Truncation kept sets equal JAX's (``truncate_logits`` exactly; the
  bisection twin away from ~1-ulp ties, which these random rows do not hit).
* Greedy decoding: the plain scan sampler vs JAX ``generate_with_temperature``
  and ``fused_generate_reference`` vs JAX ``pallas_generate(interpret=True)``.
  Exact equality is expected in float32; the asserted contract is the
  repo's distributional one (>= 99.0% first tokens, >= 97.0% rows).
* Stochastic decoding draws from different generators on the two sides, so
  it is held by a chi-square test of the first token against
  ``softmax(jax_first_step_logits / T)`` (N=20000, p > 0.001).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.models.layers import embedding as jembedding
from mlx_vae_tpu.models.layers import linear as jlinear
from mlx_vae_tpu.models.sampling import generate_with_temperature as jgenerate
from mlx_vae_tpu.ops import sampling as jsampling
from mlx_vae_tpu.ops.pallas_decoder import pallas_generate
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import hidden_init_row
from mlx_vae_tpu_torch.models.sampling import generate_with_temperature
from mlx_vae_tpu_torch.models.vae import vae_generate
from mlx_vae_tpu_torch.ops import fused_decoder as fd
from mlx_vae_tpu_torch.ops import sampling as tsampling
from mlx_vae_tpu_torch.ops.train_common import MAX_SMEM
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

AGREE_FIRST, AGREE_ROWS = 0.99, 0.97


def _model(n=2, H=128, dtype="float32", C=1, seed=0):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=H, latent_dim=8,
              num_conditions=C, num_layers=n, compute_dtype=dtype)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _inputs(cfg, B, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((B, cfg.latent_dim)) * scale).astype(np.float32)
    cond = rng.standard_normal((B, cfg.num_conditions)).astype(np.float32)
    return z, cond


def _fused_ref(tcfg, tp, z, cond, L, greedy, temp=1.0, seeds=None, **kw):
    B = z.shape[0]
    nb = -(-B // fd.block_rows(B))
    if seeds is None:
        seeds = np.random.default_rng(5).integers(0, 2**31 - 1, nb)
    w = fd.prepare_weights(tp, tcfg, "cpu")
    zt, ct = torch.from_numpy(z), torch.from_numpy(cond)
    h0 = hidden_init_row(tp, tcfg, zt, ct)
    return fd.fused_generate(w, h0, ct, torch.as_tensor(seeds, dtype=torch.int32),
                             torch.full((nb,), temp), L, greedy=greedy, **kw).numpy()


def _agreement(a, b):
    return float((a[:, 0] == b[:, 0]).mean()), float((a == b).all(1).mean())


# ---- truncation ----

TRUNC = [(3, 1.0), (0, 0.9), (6, 0.8), (1, 1.0), (0, 0.3), (23, 0.99)]


@pytest.mark.parametrize("top_k,top_p", TRUNC)
def test_truncate_logits_kept_set_matches_jax(top_k, top_p):
    x = np.random.default_rng(top_k).standard_normal((32, 24)).astype(np.float32) * 3
    want = np.isfinite(np.asarray(jsampling.truncate_logits(jnp.asarray(x), top_k, top_p)))
    got = torch.isfinite(tsampling.truncate_logits(torch.from_numpy(x), top_k, top_p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p", TRUNC)
def test_truncate_logits_bisect_kept_set_matches_jax(top_k, top_p):
    """Lane-padded rows (24 real of 32): pad lanes never count and are
    always masked, and the kept set equals JAX's bisection and the sorted
    reference."""
    x = np.random.default_rng(10 + top_k).standard_normal((32, 32)).astype(np.float32) * 3
    x[:, 24:] = 50.0  # pad lanes larger than every real logit
    want = np.asarray(jsampling.truncate_logits_bisect(jnp.asarray(x), 24, top_k, top_p)) > -1e29
    got = (tsampling.truncate_logits_bisect(torch.from_numpy(x), 24, top_k, top_p) > -1e29).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:, 24:].any()
    sorted_ref = torch.isfinite(tsampling.truncate_logits(torch.from_numpy(x[:, :24]),
                                                          top_k, top_p)).numpy()
    np.testing.assert_array_equal(got[:, :24], sorted_ref)


def test_truncation_argument_checks():
    x = torch.zeros(2, 24)
    with pytest.raises(ValueError):
        tsampling.sample_logits(x, None, top_k=-1)
    with pytest.raises(ValueError):
        tsampling.sample_logits(x, None, top_p=0.0)


# ---- greedy parity with JAX ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_greedy_scan_sampler_matches_jax(n, dtype):
    jcfg, tcfg, jp, tp = _model(n=n, dtype=dtype)
    z, cond = _inputs(jcfg, 64)
    want = np.asarray(jgenerate(jp, jcfg, jnp.asarray(z), jnp.asarray(cond),
                                jax.random.PRNGKey(3), max_length=20, greedy=True))
    got = generate_with_temperature(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                                    None, max_length=20, greedy=True).numpy()
    first, rows = _agreement(got, want)
    print(f"n={n} {dtype}: first {first:.4f} rows {rows:.4f}")
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS


@pytest.mark.parametrize("n", [1, 2, 3])
def test_greedy_fused_reference_matches_pallas_interpret(n):
    jcfg, tcfg, jp, tp = _model(n=n)
    z, cond = _inputs(jcfg, 64, seed=n)
    want = np.asarray(pallas_generate(jp, jcfg, jnp.asarray(z), jnp.asarray(cond),
                                      jax.random.PRNGKey(3), max_length=16,
                                      greedy=True, interpret=True))
    got = _fused_ref(tcfg, tp, z, cond, 16, greedy=True)
    first, rows = _agreement(got, want)
    print(f"n={n}: fused reference vs pallas interpret: first {first:.4f} "
          f"rows {rows:.4f} ({int((got != want).any(1).sum())} rows differ)")
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS


def test_fused_reference_equals_scan_sampler_greedy():
    """Same function, two implementations: identical greedy tokens."""
    _, tcfg, _, tp = _model(n=2, H=32, C=2)
    z, cond = _inputs(tcfg, 48, seed=4)
    scan = generate_with_temperature(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                                     None, max_length=12, greedy=True).numpy()
    np.testing.assert_array_equal(_fused_ref(tcfg, tp, z, cond, 12, greedy=True), scan)


# ---- stochastic: distributional ----

def _jax_first_logits(jcfg, jp, z, cond):
    h, c = jdec.initialize_hidden_state(jp, jcfg, jnp.asarray(z), jnp.asarray(cond))
    tok = jnp.full((z.shape[0],), jcfg.start_token, jnp.int32)
    x = jnp.concatenate([jembedding(jp["embedding"], tok, jcfg.dtype).astype(jnp.float32),
                         jnp.asarray(cond)], axis=1)
    out, _, _ = jdec._stacked_cell(jp, jcfg, x, h, c)
    return np.asarray(jlinear(jp["fc_out"], out, jcfg.dtype))[0]


def _chi2_p(counts, probs):
    exp = probs * counts.sum()
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


@pytest.mark.parametrize("sampler", ["fused_reference", "scan"])
def test_first_token_distribution_matches_jax_logits(sampler):
    T, N = 0.8, 20000
    jcfg, tcfg, jp, tp = _model(n=2, H=32)
    z1, c1 = _inputs(jcfg, 1, seed=7)
    logits = _jax_first_logits(jcfg, jp, z1, c1).astype(np.float64) / T
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    z, cond = np.repeat(z1, N, 0), np.repeat(c1, N, 0)
    if sampler == "scan":
        toks = generate_with_temperature(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                                         torch.Generator().manual_seed(0), max_length=1,
                                         temperature=T).numpy()
    else:
        toks = _fused_ref(tcfg, tp, z, cond, 1, greedy=False, temp=T)
    counts = np.bincount(toks[:, 0], minlength=jcfg.vocab_size).astype(np.float64)
    p = _chi2_p(counts, probs)
    print(f"{sampler}: chi-square p = {p:.4f}")
    assert p > 1e-3


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_reference_first_logits_match_jax(dtype, atol):
    """``logits_out`` (the numbers the card compares, kernel vs plain) holds
    JAX's first-step logits / T."""
    T = 0.8
    jcfg, tcfg, jp, tp = _model(n=2, H=32, dtype=dtype)
    z, cond = _inputs(jcfg, 16, seed=9)
    want = np.stack([_jax_first_logits(jcfg, jp, z[i:i + 1], cond[i:i + 1])
                     for i in range(16)]) / np.float32(T)
    got = torch.full((16, jcfg.vocab_size), float("nan"))
    _fused_ref(tcfg, tp, z, cond, 3, greedy=False, temp=T, logits_out=got)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=atol)


def test_rows_per_thread_is_checked_on_the_cpu_too():
    _, tcfg, _, tp = _model(n=1, H=32)
    z, cond = _inputs(tcfg, 8)
    base = _fused_ref(tcfg, tp, z, cond, 6, greedy=True)
    np.testing.assert_array_equal(
        _fused_ref(tcfg, tp, z, cond, 6, greedy=True, rows_per_thread=2), base)
    for bad in (3, 16):
        with pytest.raises(ValueError, match="rows_per_thread"):
            _fused_ref(tcfg, tp, z, cond, 6, greedy=True, rows_per_thread=bad)
    wide = ModelConfig(hidden_dim=32, num_layers=2, embedding_dim=4807, vocab_size=24)
    with pytest.raises(ValueError, match="shared"):
        fd._tile_rows(wide, 2)


def test_truncated_first_tokens_lie_in_jax_kept_set():
    T = 0.8
    jcfg, tcfg, jp, tp = _model(n=2, H=32)
    z1, c1 = _inputs(jcfg, 1, seed=8)
    scaled = _jax_first_logits(jcfg, jp, z1, c1) / np.float32(T)
    kept = np.isfinite(np.asarray(jsampling.truncate_logits(jnp.asarray(scaled), 6, 0.8)))
    z, cond = np.repeat(z1, 2000, 0), np.repeat(c1, 2000, 0)
    toks = _fused_ref(tcfg, tp, z, cond, 1, greedy=False, temp=T, top_k=6, top_p=0.8)
    assert kept[toks[:, 0]].all()
    assert len(np.unique(toks[:, 0])) == kept.sum() > 1


# ---- the fused sampler's own contracts ----

@pytest.mark.parametrize("greedy", [True, False])
def test_eos_rows_emit_only_pad(greedy):
    _, tcfg, _, tp = _model(n=2, H=32)
    z, cond = _inputs(tcfg, 64, seed=3, scale=2.0)
    toks = [_fused_ref(tcfg, tp, z, cond, 20, greedy=greedy, temp=1.5),
            generate_with_temperature(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                                      torch.Generator().manual_seed(1), max_length=20,
                                      temperature=1.5, greedy=greedy).numpy()]
    found = 0
    for mat in toks:
        for row in mat:
            hits = np.where(row == tcfg.end_token)[0]
            if len(hits):
                found += 1
                assert np.all(row[hits[0] + 1:] == tcfg.pad_token)
    assert found > 0


def test_seed_blocks_are_position_invariant():
    """A seed block's tokens depend only on its seed and temperature, not on
    where it sits in the batch (the serving layer's contract)."""
    _, tcfg, _, tp = _model(n=1, H=32)
    B, bb = 768, 256
    z, cond = _inputs(tcfg, B, seed=6)
    seeds = np.array([11, -5, 2**31 - 2])
    base = _fused_ref(tcfg, tp, z, cond, 8, greedy=False, temp=1.2, seeds=seeds)
    perm = [2, 0, 1]
    rows = np.concatenate([np.arange(b * bb, (b + 1) * bb) for b in perm])
    moved = _fused_ref(tcfg, tp, z[rows], cond[rows], 8, greedy=False, temp=1.2,
                       seeds=seeds[perm])
    np.testing.assert_array_equal(moved, base[rows])
    other = _fused_ref(tcfg, tp, z, cond, 8, greedy=False, temp=1.2, seeds=seeds + 1)
    assert (other != base).any()


def _lowbias32(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_hash_matches_uint32_arithmetic():
    vals = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
            *np.random.default_rng(0).integers(0, 2**32, 64).tolist()]
    got = fd._mix(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [_lowbias32(v) for v in vals]


def test_gumbel_noise_is_finite_and_centred():
    seeds = torch.tensor([3, -7], dtype=torch.int32).repeat_interleave(5000)
    rows = torch.arange(10000) % 5000
    g = fd.gumbel_noise(seeds, rows, 4, 24)
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni 0.5772, std = pi/sqrt(6)
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.std().item() - 1.2825) < 0.01


def test_kernel_gate():
    assert fd.fused_generate_supported(ModelConfig())
    assert fd.fused_generate_supported(ModelConfig(hidden_dim=1024, num_layers=4,
                                                   compute_dtype="bfloat16"))
    for bad in (dict(num_layers=9), dict(vocab_size=600), dict(hidden_dim=2048),
                dict(reference_zero_state=True)):
        assert not fd.fused_generate_supported(ModelConfig(**bad))
    # the tile plan: 8 rows per thread where shared memory allows
    assert fd._tile_rows(ModelConfig()) == 8
    assert fd._tile_rows(ModelConfig(hidden_dim=64)) == 32  # 4 row groups
    big = ModelConfig(hidden_dim=1024, num_layers=8, embedding_dim=512)
    assert fd._tile_rows(big) == 2
    assert fd._smem_bytes(big, 2) <= MAX_SMEM < fd._smem_bytes(big, 4)


def test_cpu_wrapper_runs_plain_version_without_counting():
    _, tcfg, _, tp = _model(n=1, H=32)
    z, cond = _inputs(tcfg, 8)
    before = fd.fused_generate.launches
    _fused_ref(tcfg, tp, z, cond, 4, greedy=True)
    assert fd.fused_generate.launches == before
    w = fd.prepare_weights(tp, tcfg.replace(reference_zero_state=True), "cpu")
    with pytest.raises(NotImplementedError):
        fd.fused_generate(w, torch.zeros(8, 32), torch.zeros(8, 1),
                          torch.zeros(1, dtype=torch.int32), torch.ones(1), 4)


def test_vae_generate_cpu_paths():
    _, tcfg, _, tp = _model(n=2, H=32)
    cond = torch.zeros(40, 1)
    a = vae_generate({"decoder": tp}, tcfg, cond, torch.Generator().manual_seed(3),
                     max_length=10, temperature=0.9)
    b = vae_generate({"decoder": tp}, tcfg, cond, torch.Generator().manual_seed(3),
                     max_length=10, temperature=0.9)
    assert a.shape == (40, 10) and a.dtype == torch.int32
    assert torch.equal(a, b)
    # greedy: z is the generator's first draw, then the fused plain version
    g = vae_generate({"decoder": tp}, tcfg, cond, torch.Generator().manual_seed(3),
                     max_length=10, greedy=True)
    z = torch.randn((40, 8), generator=torch.Generator().manual_seed(3))
    want = generate_with_temperature(tp, tcfg, z, cond, None, max_length=10, greedy=True)
    assert torch.equal(g, want)


def test_greedy_scan_sampler_zero_state_matches_jax():
    """reference_zero_state (every step from zero LSTM state) lives only in
    the plain scan sampler; hold it against JAX's."""
    jcfg, tcfg, jp, tp = _model(n=2, H=32)
    jcfg, tcfg = jcfg.replace(reference_zero_state=True), tcfg.replace(reference_zero_state=True)
    z, cond = _inputs(jcfg, 32)
    want = np.asarray(jgenerate(jp, jcfg, jnp.asarray(z), jnp.asarray(cond),
                                jax.random.PRNGKey(3), max_length=12, greedy=True))
    got = generate_with_temperature(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                                    None, max_length=12, greedy=True).numpy()
    first, rows = _agreement(got, want)
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS
