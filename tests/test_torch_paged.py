"""Paged KV-cache serving of the PyTorch port against the JAX package.

* Kernel level: the port's ``paged_attention_plain`` (what its wrapper runs
  on CPU tensors) against the JAX ``paged_attention_kernel`` run directly in
  interpret mode, as tests/test_paged.py runs it, and against
  ``paged_attention_reference``.  Tolerances: fp32 and int8 rtol = atol =
  2e-5 (the JAX kernel test's; same arithmetic, other summation order);
  bf16 1e-2 of the largest value (bf16 keeps ~3 significant digits, and P
  is rounded against another running max).  Rows of length 0 are exactly 0.
* Decoder: the port's ``PagedDecoder`` tokens against the JAX package's
  synchronous oracle ``dense_reference_decode`` on the same weights
  (``convert.paged_toy_lm_from_jax``), token for token in fp32, and at a
  match rate >= 0.9 with int8 KV blocks (the JAX package's gate).  The
  JAX ``PagedDecoder`` is not an oracle here: it hands host buffers to an
  async call that may read them after the host rewrote them.
* Allocator, hashes, calibration, metrics and the host-buffer snapshot:
  port against port and against the JAX package's functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import errors as jerrors
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import paged as JP
from paddle_tpu.utils import monitor as jmonitor
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.ops.kernels import config
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import paged as TP
from paddle_tpu_torch.serving import slo as tslo
from paddle_tpu_torch.serving import (AdmissionError, BlockPool, DecodeHandle,
                                      PagedDecoder, PagedKVCache, PrefixCache,
                                      dense_reference_decode, kv_pool_bytes,
                                      make_paged_toy_lm)
from paddle_tpu_torch.utils import monitor as tmonitor

FP32_TOL = 2e-5
BF16_REL = 1e-2
MIN_INT8_MATCH = 0.9
CONFIG = dict(vocab=64, hidden=32, max_positions=256, seed=3)
KEYS = ("emb", "pe", "wq", "wk", "wv", "wo")


@pytest.fixture(autouse=True)
def _metrics_on():
    saved = flags.get_flag("metrics")
    flags.set_flags({"metrics": True})
    yield
    flags.set_flags({"metrics": saved})


@pytest.fixture(scope="module")
def jax_model():
    return JP.make_paged_toy_lm(**CONFIG)


@pytest.fixture(scope="module")
def model(jax_model):
    weights = {k: np.asarray(getattr(jax_model, k)) for k in KEYS}
    return convert.paged_toy_lm_from_jax(weights, **CONFIG, device="cpu")


@pytest.fixture(scope="module")
def oracle(jax_model):
    """The JAX package's dense_reference_decode, memoised per request."""
    memo = {}

    def ref(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in memo:
            memo[key] = JP.dense_reference_decode(jax_model, prompt, max_new)
        return memo[key]
    return ref


def _mk(model, num_blocks=64, block_size=8, max_seqs=8, maxb=16, chunk=8,
        kv_dtype="float32"):
    cache = PagedKVCache(model, num_blocks, block_size, kv_dtype=kv_dtype)
    dec = PagedDecoder(model, cache, max_seqs=max_seqs,
                       max_blocks_per_seq=maxb, prefill_chunk=chunk)
    return cache, dec


# -- the kernel's plain version against the JAX kernel ------------------------

def _kernel_case(seed, dtype, num_seqs=4, max_blocks=3, block_size=8, d=128):
    """tests/test_paged.py's inputs: lengths 0, 3, block_size and the full
    table; int8 blocks with random per-block scales."""
    rng = np.random.default_rng(seed)
    num_blocks = num_seqs * max_blocks + 1
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, (num_blocks, block_size, d))
                .astype(np.int8) for _ in range(2))
        scales = rng.uniform(0.01, 0.1, (num_blocks, 2)).astype(np.float32)
    else:
        k, v = (rng.normal(size=(num_blocks, block_size, d))
                .astype(np.float32) for _ in range(2))
        scales = None
    q = rng.normal(size=(num_seqs, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_blocks))[
        :num_seqs * max_blocks].reshape(num_seqs, max_blocks).astype(np.int32)
    lens = np.array([0, 3, block_size, max_blocks * block_size][:num_seqs],
                    np.int32)
    return q, k, v, tables, lens, scales


def _as_jax(case, dtype):
    q, k, v, tables, lens, scales = case
    fdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}.get(dtype, jnp.float32)
    kw = {} if scales is None else {"kv_scales": jnp.asarray(scales)}
    return (jnp.asarray(q, fdt), jnp.asarray(k, kdt), jnp.asarray(v, kdt),
            jnp.asarray(tables), jnp.asarray(lens)), kw


def _as_torch(case, dtype):
    q, k, v, tables, lens, scales = case
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kdt = {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(
        dtype, torch.float32)
    kw = {} if scales is None else {"kv_scales": torch.from_numpy(scales)}
    return (torch.from_numpy(q).to(fdt), torch.from_numpy(k).to(kdt),
            torch.from_numpy(v).to(kdt), torch.from_numpy(tables),
            torch.from_numpy(lens)), kw


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("seed", [6, 7])
def test_plain_matches_jax_paged_attention_kernel(dtype, seed):
    case = _kernel_case(seed, dtype)
    jargs, jkw = _as_jax(case, dtype)
    targs, tkw = _as_torch(case, dtype)
    ref = _f32(jpa.paged_attention_kernel(*jargs, sm_scale=0.088, **jkw))
    out = tpa.paged_attention_plain(*targs, sm_scale=0.088, **tkw)
    assert out.dtype == targs[0].dtype
    got = out.float().numpy()
    if dtype == "bfloat16":
        assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
    lens = case[4]
    assert np.all(got[lens == 0] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_matches_jax_paged_attention_reference(dtype):
    case = _kernel_case(8, dtype)
    jargs, jkw = _as_jax(case, dtype)
    targs, tkw = _as_torch(case, dtype)
    ref = _f32(jpa.paged_attention_reference(*jargs, sm_scale=0.088, **jkw))
    out = tpa.paged_attention_plain(*targs, sm_scale=0.088, **tkw).numpy()
    np.testing.assert_allclose(out, ref, rtol=FP32_TOL, atol=FP32_TOL)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    targs, _ = _as_torch(_kernel_case(9, "float32", d=32), "float32")
    config.reset_counts()
    out = tpa.paged_attention(*targs)          # sm_scale 1/sqrt(d)
    ref = tpa.paged_attention_plain(*targs, sm_scale=1 / np.sqrt(32))
    assert torch.equal(out, ref)
    assert config.launch_counts() == {}


def test_plain_broadcast_table_matches_repeated_rows():
    """A chunked prefill hands the kernel one table with row stride 0."""
    q, k, v, tables, _, _ = _kernel_case(10, "float32", num_seqs=6)
    lens = np.arange(1, 7, dtype=np.int32) * 3
    one = torch.from_numpy(tables[:1])
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    out_b = tpa.paged_attention_plain(*args, one.expand(6, 3),
                                      torch.from_numpy(lens))
    out_r = tpa.paged_attention_plain(*args, one.repeat(6, 1).contiguous(),
                                      torch.from_numpy(lens))
    assert torch.equal(out_b, out_r)


def test_wrapper_raises_on_devices_other_than_cpu_and_cuda():
    targs, _ = _as_torch(_kernel_case(11, "float32", d=32), "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(*(t.to("meta") for t in targs))


def test_wrapper_requires_scales_for_int8():
    targs, _ = _as_torch(_kernel_case(12, "int8", d=32), "int8")
    with pytest.raises(ValueError, match="kv_scales"):
        tpa.paged_attention(*targs)


@pytest.mark.parametrize("num_seqs,max_blocks,block_size,d,elt", [
    (4, 3, 8, 128, 4), (256, 128, 16, 128, 1), (64, 256, 16, 128, 4)])
def test_cost_model_matches_jax(num_seqs, max_blocks, block_size, d, elt):
    assert tpa.paged_attention_cost(num_seqs, max_blocks, block_size, d,
                                    elt) == jpa.paged_attention_cost(
        num_seqs, max_blocks, block_size, d, elt)


def test_supported_shapes_cover_the_slice():
    assert tpa.supported(64, 16, 128, torch.float32)
    assert tpa.supported(4, 8, 32, torch.int8)       # the CPU tests' shape
    assert tpa.supported(4, 1, 256, torch.bfloat16)
    assert not tpa.supported(4, 8, 48, torch.float32)
    assert not tpa.supported(4, 65, 128, torch.float32)
    assert not tpa.supported(4, 8, 128, torch.float16)


def test_kernel_declared_with_source_and_flag():
    (k,) = tpa.KERNELS
    assert k.name == "paged_attention" and k.source == "paged_attention"
    assert k.replaces == ("paddle_tpu/ops/pallas/paged_attention.py:116 "
                          "paged_attention_kernel")
    assert k.wrapper is tpa.paged_attention
    assert k.plain is tpa.paged_attention_plain
    assert ("pgat", "use_paged_attention") in config._KERNEL_FLAGS


# -- the decoder against the JAX package's dense oracle ----------------------

@pytest.mark.parametrize("plen", [1, 3, 7, 8, 9, 16, 17, 30])
def test_paged_tokens_match_jax_dense_reference(model, oracle, plen):
    """Prompt lengths straddle the block (8) and chunk (8) boundaries."""
    _, dec = _mk(model)
    prompt = np.random.default_rng(plen).integers(1, 64, plen).tolist()
    h = dec.join(prompt, 6)
    dec.run_until_idle()
    assert not h.evicted and h.done
    assert h.tokens == oracle(prompt, 6)


@pytest.mark.parametrize("plen", [3, 17])
def test_port_dense_reference_matches_jax(model, oracle, plen):
    prompt = np.random.default_rng(100 + plen).integers(1, 64, plen).tolist()
    assert dense_reference_decode(model, prompt, 6) == oracle(prompt, 6)


def test_staggered_joins_match_jax_dense_reference(model, oracle):
    _, dec = _mk(model, max_seqs=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 64, rng.integers(2, 14)).tolist()
               for _ in range(10)]
    out = dec.decode(prompts, max_new_tokens=8)
    for prompt, toks in zip(prompts, out):
        assert toks == oracle(prompt, 8)


def test_prefix_hit_identity_minimal_chunks(model, oracle):
    """A warm join resolves the shared system prompt from the cache: 4 hits,
    one prefill chunk against five, the same tokens."""
    _, dec = _mk(model, chunk=8)
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, 64, 32).tolist() + [5, 6, 7]   # 4 full blocks

    chunks0 = TP.KV_PREFILL_CHUNKS.value()
    h_cold = dec.join(prompt, 5)
    dec.run_until_idle()
    cold_chunks = TP.KV_PREFILL_CHUNKS.value() - chunks0

    hits0 = TP.KV_PREFIX_HITS.value()
    chunks1 = TP.KV_PREFILL_CHUNKS.value()
    h_warm = dec.join(prompt, 5)
    dec.run_until_idle()
    assert TP.KV_PREFILL_CHUNKS.value() - chunks1 == 1
    assert cold_chunks == 5
    assert TP.KV_PREFIX_HITS.value() - hits0 == 4
    assert h_warm.tokens == h_cold.tokens == oracle(prompt, 5)


def test_two_decoders_share_prefix_blocks_on_one_cache(model, oracle):
    cache = PagedKVCache(model, 64, 8)
    dec_a = PagedDecoder(model, cache, max_seqs=2, max_blocks_per_seq=16,
                         tenant="a")
    dec_b = PagedDecoder(model, cache, max_seqs=2, max_blocks_per_seq=16,
                         tenant="b")
    prompt = np.random.default_rng(3).integers(1, 64, 16).tolist() + [9]
    h_a = dec_a.join(prompt, 4)
    dec_a.run_until_idle()
    hits0 = TP.KV_PREFIX_HITS.value()
    h_b = dec_b.join(prompt, 4)
    assert cache.pool.live_count > 0
    dec_b.run_until_idle()
    assert TP.KV_PREFIX_HITS.value() - hits0 == 2
    assert h_a.tokens == h_b.tokens == oracle(prompt, 4)


def test_int8_kv_token_match_rate(model, oracle):
    """int8 blocks are lossy: greedy argmax can flip on near-ties, so the
    gate is the token match rate against the fp32 oracle."""
    cache, dec = _mk(model, kv_dtype="int8")
    assert cache.k.dtype == torch.int8
    rng = np.random.default_rng(8)
    total = matched = 0
    for _ in range(12):
        prompt = rng.integers(1, 64, rng.integers(3, 20)).tolist()
        h = dec.join(prompt, 8)
        dec.run_until_idle()
        ref = oracle(prompt, 8)
        matched += sum(a == b for a, b in zip(h.tokens, ref))
        total += len(ref)
    assert matched / total >= MIN_INT8_MATCH, f"{matched}/{total}"


def test_int8_store_rounds_half_to_even_and_clips(model):
    cache, dec = _mk(model, num_blocks=4, kv_dtype="int8")
    s = cache.k_scale
    vals = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -300.0]) * s
    got = dec._store(vals, s).tolist()
    assert got == [0, 2, 2, 0, -2, 127, -127]


def test_plain_path_flag_gives_the_same_tokens(model, oracle):
    prompt = [4, 9, 1, 33, 2, 2, 7, 8, 60, 11]
    try:
        flags.set_flags({"use_paged_attention": False})
        assert "pgat=0" in config.fingerprint()
        _, dec = _mk(model)
        h = dec.join(prompt, 6)
        dec.run_until_idle()
    finally:
        flags.set_flags({"use_paged_attention": True})
    assert h.tokens == oracle(prompt, 6)


# -- host buffers -------------------------------------------------------------

def test_stage_copies_host_buffers(model):
    _, dec = _mk(model)
    dec._meta_np[:] = np.arange(5 * dec.max_seqs).reshape(5, -1)
    dec._tables_np[:] = 3
    meta, tables = dec._stage(dec._meta_np, dec._tables_np[:, :4])
    want_meta, want_tables = meta.clone(), tables.clone()
    dec._meta_np.fill(-7)
    dec._tables_np.fill(-7)
    assert torch.equal(meta, want_meta) and torch.equal(tables, want_tables)
    assert tables.shape == (dec.max_seqs, 4)


def test_step_results_survive_host_buffer_rewrites(model, oracle,
                                                   monkeypatch):
    """The host rewrites ``_meta_np``, ``_pf_meta_np`` and ``_tables_np``
    while a step is still reading its inputs (here: inside the attention
    call); the tokens must not change."""
    _, dec = _mk(model, max_seqs=3)
    real = tpa.paged_attention
    calls = []

    def scribbling(*args, **kwargs):
        saved = [b.copy() for b in (dec._meta_np, dec._pf_meta_np,
                                    dec._tables_np)]
        for b in (dec._meta_np, dec._pf_meta_np, dec._tables_np):
            b.fill(1)
        try:
            calls.append(1)
            return real(*args, **kwargs)
        finally:
            for b, s in zip((dec._meta_np, dec._pf_meta_np,
                             dec._tables_np), saved):
                b[...] = s

    monkeypatch.setattr(tpa, "paged_attention", scribbling)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 64, n).tolist() for n in (5, 12, 19)]
    out = dec.decode(prompts, max_new_tokens=5)
    assert calls
    for prompt, toks in zip(prompts, out):
        assert toks == oracle(prompt, 5)


# -- allocator physics ----------------------------------------------------------

def test_block_pool_alloc_free_refcount_physics():
    pool = BlockPool(4)
    bids = [pool.alloc() for _ in range(4)]
    assert sorted(bids) == [1, 2, 3, 4]   # block 0 is the pinned null
    assert pool.alloc() is None
    pool.share(bids[0])
    pool.free(bids[0])
    assert pool.free_count == 0           # one ref still held
    pool.free(bids[0])
    assert pool.free_count == 1 and pool.refcount(bids[0]) == 0
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(bids[0])
    with pytest.raises(RuntimeError, match="null block"):
        pool.free(0)
    with pytest.raises(RuntimeError, match="unallocated"):
        pool.share(bids[0])
    with pytest.raises(ValueError):
        BlockPool(0)


def test_block_pool_hands_out_the_jax_order():
    jpool, tpool = JP.BlockPool(6), BlockPool(6)
    held, order = [], []
    for op in (0, 0, 0, 1, 0, 0, 1, 1, 0, 0):
        if op == 0:
            pair = (jpool.alloc(), tpool.alloc())
            held.append(pair)
            order.append(pair)
        else:
            j, t = held.pop(0)
            jpool.free(j)
            tpool.free(t)
    assert all(a == b for a, b in order)
    assert jpool.free_count == tpool.free_count


def test_prefix_cache_reclaim_frees_lru_entries():
    pool = BlockPool(4)
    cache = PrefixCache(pool)
    a, b = pool.alloc(), pool.alloc()
    cache.put("ha", a)
    cache.put("hb", b)
    pool.free(a)
    pool.free(b)                          # only the cache's refs remain
    assert pool.free_count == 2
    assert cache.reclaim(1) == 1          # LRU entry "ha" dropped
    assert pool.free_count == 3
    assert cache.get("ha") is None
    assert cache.get("hb") == b           # re-shared: caller now holds a ref
    pool.free(b)
    assert len(cache) == 1


def test_no_double_free_under_join_evict_churn(model):
    cache, dec = _mk(model, num_blocks=16, max_seqs=4, maxb=8)
    rng = np.random.default_rng(4)
    live = []
    for _ in range(120):
        op = rng.integers(0, 3)
        if op == 0:
            h = dec.try_join(rng.integers(1, 64, rng.integers(1, 20)).tolist(),
                             int(rng.integers(1, 8)))
            if h is not None:
                live.append(h)
        elif op == 1 and live:
            dec.evict(live.pop(int(rng.integers(0, len(live)))))
        else:
            dec.step()
    dec.run_until_idle()
    assert all(h.done for h in live)
    assert dec.active_count == 0
    cache.prefix.reclaim(cache.pool.num_blocks)
    assert len(cache.prefix) == 0
    assert cache.pool.free_count == cache.pool.num_blocks


def test_evict_mid_decode_keeps_tokens_and_frees_blocks(model):
    cache, dec = _mk(model, num_blocks=16, max_seqs=2, maxb=8)
    h = dec.join([1, 2, 3], 50)
    for _ in range(5):
        dec.step()
    got = list(h.tokens)
    assert got
    free0 = cache.pool.free_count
    dec.evict(h)
    assert h.evicted and h.done and h.tokens == got
    assert cache.pool.free_count > free0
    assert dec.active_count == 0


def test_join_sheds_on_slots_and_blocks(model):
    _, dec = _mk(model, num_blocks=64, max_seqs=1, maxb=8)
    dec.join([1, 2, 3], 4)
    shed0 = tslo.LOAD_SHED.value(reason="slots")
    with pytest.raises(AdmissionError, match="slots"):
        dec.join([4, 5, 6], 4)
    assert tslo.LOAD_SHED.value(reason="slots") == shed0 + 1
    _, tiny = _mk(model, num_blocks=2, max_seqs=2, maxb=8)
    with pytest.raises(AdmissionError, match="kv_blocks"):
        tiny.join(list(range(1, 18)), 2)
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        tiny.join(list(range(1, 60)), 10)
    with pytest.raises(ValueError, match="empty prompt"):
        tiny.join([], 2)


# -- pool sizes, fingerprints, hashes, calibration ------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("num_blocks,block_size,hidden", [
    (64, 8, 32), (16384, 16, 128), (32768, 16, 128)])
def test_kv_pool_bytes_match_jax(num_blocks, block_size, hidden, kv_dtype):
    assert kv_pool_bytes(num_blocks, block_size, hidden, kv_dtype) \
        == JP.kv_pool_bytes(num_blocks, block_size, hidden, kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_cache_allocates_what_kv_pool_bytes_prices(model, kv_dtype):
    cache = PagedKVCache(model, 64, 8, kv_dtype=kv_dtype)
    held = sum(t.numel() * t.element_size()
               for t in (cache.k, cache.v, cache.scales))
    assert cache.bytes == held == kv_pool_bytes(64, 8, model.hidden,
                                                kv_dtype)
    assert TP.KV_CACHE_BYTES.value() == float(cache.bytes)
    assert cache.k.shape == (65, 8, model.hidden)


@pytest.mark.parametrize("vocab,hidden,max_positions,seed", [
    (64, 32, 256, 3), (32000, 128, 4096, 0), (7, 8, 9, 123)])
def test_fingerprint_is_the_jax_string(vocab, hidden, max_positions, seed):
    args = dict(vocab=vocab, hidden=hidden, max_positions=max_positions,
                seed=seed)
    assert make_paged_toy_lm(**args, device="cpu").fingerprint \
        == JP.make_paged_toy_lm(**args).fingerprint


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("block_size", [4, 8])
def test_block_hashes_are_the_jax_strings(jax_model, model, kv_dtype,
                                          block_size):
    jcache = JP.PagedKVCache(jax_model, 8, block_size, kv_dtype=kv_dtype)
    tcache = PagedKVCache(model, 8, block_size, kv_dtype=kv_dtype)
    toks = np.random.default_rng(block_size).integers(1, 64, 35).tolist()
    assert tcache.block_hashes(toks) == jcache.block_hashes(toks)
    assert len(tcache.block_hashes(toks)) == 35 // block_size


def test_hashes_namespace_model_and_dtype(model):
    other = make_paged_toy_lm(vocab=64, hidden=32, max_positions=256,
                              seed=4, device="cpu")
    c32, c8 = PagedKVCache(model, 8, 8), PagedKVCache(model, 8, 8, "int8")
    toks = list(range(16))
    assert c32.block_hashes(toks) != c8.block_hashes(toks)
    assert c32.block_hashes(toks) != PagedKVCache(other, 8, 8).block_hashes(
        toks)


@pytest.mark.parametrize("per", [1, 7, 64])
def test_chunked_calibration_is_bit_identical(model, jax_model, per,
                                              monkeypatch):
    position_bytes = model.vocab * model.hidden * 4
    monkeypatch.setattr(TP, "_CALIBRATION_CHUNK_BYTES",
                        model.max_positions * position_bytes)
    whole = model.calibrate_kv_scales()
    monkeypatch.setattr(TP, "_CALIBRATION_CHUNK_BYTES", per * position_bytes)
    assert model.calibrate_kv_scales() == whole
    np.testing.assert_allclose(whole, jax_model.calibrate_kv_scales(),
                               rtol=1e-6)


def test_converter_checks_keys_and_shapes(jax_model):
    weights = {k: np.asarray(getattr(jax_model, k)) for k in KEYS}
    with pytest.raises(KeyError, match="missing"):
        convert.paged_toy_lm_from_jax(
            {k: v for k, v in weights.items() if k != "wo"}, **CONFIG,
            device="cpu")
    bad = dict(weights, pe=weights["pe"][:10])
    with pytest.raises(ValueError, match="pe"):
        convert.paged_toy_lm_from_jax(bad, **CONFIG, device="cpu")
    m = convert.paged_toy_lm_from_jax(weights, **CONFIG, device="cpu")
    for k in KEYS:
        assert np.array_equal(getattr(m, k).numpy(), weights[k])
    np.testing.assert_allclose(
        m.qkv(torch.tensor([1, 2]), torch.tensor([0, 5]))[1].numpy(),
        np.asarray(jax_model.qkv(jnp.asarray([1, 2]), jnp.asarray([0, 5]))[1]),
        rtol=1e-6, atol=1e-7)


def test_model_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_paged_toy_lm()


# -- metrics, errors, handles ---------------------------------------------------

def test_decode_records_ttft_request_and_chunk_metrics(model):
    _, dec = _mk(model)
    ttft0 = tslo.TTFT_MS.count()
    req0 = tslo.REQUEST_MS.count(tenant="default", bucket="decode")
    chunks0 = TP.KV_PREFILL_CHUNKS.value()
    dec.decode([[1, 2, 3], list(range(1, 20))], 3)
    assert tslo.TTFT_MS.count() == ttft0 + 2
    assert tslo.REQUEST_MS.count(tenant="default", bucket="decode") \
        == req0 + 2
    assert TP.KV_PREFILL_CHUNKS.value() - chunks0 == 1 + 3
    assert TP.KV_BLOCKS_FREE.value() == dec.cache.pool.free_count


def test_metrics_flag_off_records_nothing():
    reg = tmonitor.MetricRegistry()
    c, h = reg.counter("t.c"), reg.histogram("t.h")
    flags.set_flags({"metrics": False})
    c.inc()
    h.observe(1.0)
    assert c.value() == 0 and h.count() == 0
    flags.set_flags({"metrics": True})
    c.inc(2)
    assert c.value() == 2
    assert reg.counter("t.c") is c
    with pytest.raises(ValueError):
        reg.gauge("t.c")


@pytest.mark.parametrize("q", [0, 50, 90, 99, 100])
def test_histogram_percentile_matches_jax(q):
    vals = np.random.default_rng(5).lognormal(1.0, 1.5, 200)
    jreg, treg = jmonitor.MetricRegistry(), tmonitor.MetricRegistry()
    jh = jreg.histogram("t.lat", labelnames=("k",))
    th = treg.histogram("t.lat", labelnames=("k",))
    for v in vals:
        jh.observe(v, k="a")
        th.observe(v, k="a")
    assert th.percentile(q, k="a") == jh.percentile(q, k="a")
    assert th.count(k="a") == jh.count(k="a")
    assert np.isnan(th.percentile(q, k="b"))


def test_metric_names_are_the_jax_names():
    names = set(tmonitor.default_registry().names())
    for name in ("serve.kv_blocks_free", "serve.kv_cache_bytes",
                 "serve.kv_prefix_hits", "serve.kv_prefill_chunks",
                 "serve.load_shed", "serve.request_ms", "serve.ttft_ms"):
        assert name in names
        assert jmonitor.default_registry().get(name) is not None


def test_error_taxonomy_matches_jax():
    for name in ("EnforceNotMet", "ResourceExhaustedError"):
        t, j = getattr(terrors, name), getattr(jerrors, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__]
    assert issubclass(tslo.QuotaExceededError, AdmissionError)
    assert issubclass(AdmissionError, MemoryError)


def test_decode_handle_fields():
    h = DecodeHandle(np.array([3, 4]), 5)
    assert h.prompt == [3, 4] and h.max_new_tokens == 5
    assert h.tokens == [] and not h.done and not h.evicted and h.slot is None
