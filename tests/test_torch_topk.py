"""The topk compatibility mode and the reference-shaped ops of the port on
the CPU, against the JAX package run in the same process.

The ops (ops/dct.py, ops/affine.py, ops/search.py, ops/index.py,
ops/perceptual.py, ops/domains.py) on seeded inputs: embeddings within
1e-6 of the unit vectors' scale (the port sums the (N, k) map pairwise, as
the JAX CPU dot does, but normalizes with plain float32 sums where XLA may
fuse a multiply-add), shortlists and picks exact; the blockwise top-k
merge exactly equal to the JAX package's `_topk_merge_scan` on scores
with exact ties planted inside a block and across blocks.

The encode with search="topk" (ops/search.py topk_search_block over
range blocks, no CUDA kernel) on bench.make_signal(1.0), single-shot, in a
packed stack of 3 and through the stream's masked shards: the same
sentinel set as the JAX CPU run; idx equal but at ties: the float64
selection scores of both picks agree to 1e-5 of the range's energy (the
scale of the float32 arithmetic that ranks them: err2 = r_e - 2 s num +
s^2 denom cancels), and at most 2 rows per 1,024 are not exact ties
(agreement to 1e-12, tiles equivalent for that range); round-trip SNR
within 0.01 dB; a packed file's records equal its single encode's
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import fwav_tpu_torch as port
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
from fwav_tpu.models.stream import compress_audio_streaming as jax_stream
from fwav_tpu.ops import affine as JA
from fwav_tpu.ops import dct as JD
from fwav_tpu.ops import domains as JDom
from fwav_tpu.ops import index as JI
from fwav_tpu.ops import perceptual as JP
from fwav_tpu.ops import search as JS
from fwav_tpu.utils.metrics import compute_snr
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.ops import affine as TA
from fwav_tpu_torch.ops import dct as TD
from fwav_tpu_torch.ops import domains as TDom
from fwav_tpu_torch.ops import index as TI
from fwav_tpu_torch.ops import kernels, near_tie
from fwav_tpu_torch.ops import perceptual as TP
from fwav_tpu_torch.ops import search as TS
from native_libs import ensure_native_libraries

ensure_native_libraries()

torch.set_num_threads(2)

#: Near-tie bar of the topk picks: float64 selection scores within this
#: fraction of the range's centered energy.
TOPK_RTOL_OF_ENERGY = 1e-5
#: Picks whose float64 selection scores agree to this fraction of the
#: range's energy are exact ties (tiles equivalent for that range, as at
#: the edge of a silent gap): either pick decodes alike, and they are not
#: counted against the near-tie bar (the exact-tie carve-out).
EXACT_TIE_RTOL = 1e-12
_CACHE = {}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- ops/dct.py ---------------------------------------------------------------


def test_maps_are_copies():
    for n in (4, 6, 8, 16):
        np.testing.assert_array_equal(TD.dct2_matrix(n), JD.dct2_matrix(n))
        for k in (4, 8, 32):
            for name in ("_tile_embed_map", "_transient_embed_map", "_tonal_embed_map"):
                np.testing.assert_array_equal(getattr(TD, name)(n, k), getattr(JD, name)(n, k))


@pytest.mark.parametrize("n", [4, 6, 8, 16])
@pytest.mark.parametrize("fn", ["tile_embedding_batch", "transient_embedding_batch",
                                "tonal_embedding_batch", "multi_head_embedding_batch"])
def test_batch_embeddings_match_jax(fn, n):
    x = (_rng(n).standard_normal((3000, n)) * 3000).astype(np.float32)
    x[::97] = 0.0                      # silent rows stay unnormalized zeros
    got = getattr(TD, fn)(_t(x)).numpy()
    want = np.asarray(getattr(JD, fn)(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[::97], want[::97])


@pytest.mark.parametrize("fn", ["tile_embedding", "transient_embedding", "tonal_embedding",
                                "multi_head_embedding"])
def test_single_tile_embeddings_match_jax(fn):
    for n in (4, 8, 32):
        x = _rng(n).standard_normal(n).astype(np.float32)
        got, want = getattr(TD, fn)(x, device="cpu"), np.asarray(getattr(JD, fn)(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_energy_and_correlation_bound():
    x = _rng(1).standard_normal(16).astype(np.float32)
    y = _rng(2).standard_normal(16).astype(np.float32)
    assert TD.quick_energy(x) == JD.quick_energy(x)
    args = (x, y, float(np.linalg.norm(x)), float(np.linalg.norm(y)))
    assert TD.correlation_upper_bound(*args) == JD.correlation_upper_bound(*args)
    assert TD.correlation_upper_bound(x, y, 0.0, 1.0) == 0.0


def test_tf32_guard_restores_the_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    with TD.ieee_fp32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_tf32_guard_blocks_take_turns():
    """Two threads' blocks do not overlap: the second enters only after the
    first has restored the flag, so no restore lands under a product."""
    import threading
    import time

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    inside, events = threading.Event(), []

    def first():
        with TD.ieee_fp32_matmul():
            inside.set()
            time.sleep(0.2)
            events.append(("first", torch.backends.cuda.matmul.allow_tf32))
        events.append(("first out", None))

    def second():
        inside.wait()
        with TD.ieee_fp32_matmul():
            events.append(("second", torch.backends.cuda.matmul.allow_tf32))

    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert events[0] == ("first", False) and events[-1] == ("second", False)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


#: The reference-shaped public functions that take `device`, with one
#: call of each on small inputs and the default device.
_TILE = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
_BANK = np.stack([_TILE, _TILE[::-1], _TILE ** 2])
_DEFAULT_DEVICE_CALLS = {
    "tile_embedding": lambda: TD.tile_embedding(_TILE),
    "transient_embedding": lambda: TD.transient_embedding(_TILE),
    "tonal_embedding": lambda: TD.tonal_embedding(_TILE),
    "multi_head_embedding": lambda: TD.multi_head_embedding(_TILE),
    "find_best_domain_affine": lambda: TA.find_best_domain_affine(_TILE, _BANK, [0, 1]),
    "affine_solve_single": lambda: TA.affine_solve_single(_TILE, _TILE[::-1].copy()),
    "range_candidates_from_embedding": lambda: TS.range_candidates_from_embedding(
        _TILE, np.eye(16, dtype=np.float32)),
    "MIPSIndex.query": lambda: TI.MIPSIndex(np.eye(16, dtype=np.float32)).query(
        np.ones((2, 16), np.float32)),
    "ann_query": lambda: TI.ann_query(_TILE, "missing.ann"),
    "perceptual_error_batch": lambda: TP.perceptual_error_batch(_BANK, _TILE),
    "pruned_affine_search": lambda: TP.pruned_affine_search(_TILE, [0, 1, 2], _BANK),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_reference_shaped_ops_default_to_the_card(name):
    """Each function takes `device`, "cuda" by default, as the encode entry
    points do: without a card the default raises, never runs on the CPU."""
    import inspect

    owner = {"MIPSIndex.query": TI.MIPSIndex.query}.get(name)
    fn = owner or next(getattr(m, name) for m in (TD, TA, TS, TI, TP) if hasattr(m, name))
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be honoured")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name]()


def test_build_domain_embeddings_defaults_to_the_card(tmp_path):
    import inspect

    sig = inspect.signature(TI.build_domain_embeddings)
    assert sig.parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be honoured")
    dom = tmp_path / "domains.f32"
    _BANK.tofile(dom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.build_domain_embeddings(str(dom), 3, 8, tmpdir=tmp_path)


# --- ops/affine.py --------------------------------------------------------------


def _close_to_energy(got, want, ranges, rtol=1e-6):
    """Residual-like values (err, err^2, selection scores) agree to rtol of
    the range's centered energy, the scale of the float32 terms they cancel
    from (an err's to the square root of it); infinities where the other's."""
    r = ranges.astype(np.float64)
    r_e = ((r - r.mean(1, keepdims=True)) ** 2).sum(1)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    a, b = got[fin].astype(np.float64), want[fin].astype(np.float64)
    tol = rtol * r_e[fin]
    tol = np.where(a * a < 2 * r_e[fin], np.maximum(tol, np.sqrt(tol)), tol)
    assert (np.abs(a - b) <= tol + 1e-5 * np.abs(b)).all(), np.max(np.abs(a - b) - tol)


def _affine_inputs(seed, B=600, K=12, D=500, N=4):
    rng = _rng(seed)
    ranges = (rng.standard_normal((B, N)) * 1000).astype(np.float32)
    bank = (rng.standard_normal((D, N)) * 1000).astype(np.float32)
    cand = rng.integers(0, D, (B, K)).astype(np.int32)
    cand[::7, 3:] = -1
    cand[5::50] = -1                   # every slot empty
    return ranges, bank, cand


@pytest.mark.parametrize("objective", ["affine", "balanced", "damped"])
def test_batched_affine_match_matches_jax(objective):
    ranges, bank, cand = _affine_inputs(3)
    got = TA.batched_affine_match(_t(ranges), _t(cand), _t(bank), s_clip=4.0,
                                  objective=objective, return_score=True)
    want = JA.batched_affine_match(jnp.asarray(ranges), jnp.asarray(cand), jnp.asarray(bank),
                                   s_clip=4.0, objective=objective, return_score=True)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for k in (0, 3, 6):                # idx, sym, the pick's position
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5)              # s
    np.testing.assert_allclose(got[2], want[2], rtol=2e-5, atol=1e-2)   # o
    for k in (4, 5):                   # err and the selection score
        _close_to_energy(got[k], want[k], ranges)
    assert np.isinf(got[4][5::50]).all() and np.isinf(got[5][5::50]).all()


def test_affine_match_tiles_and_single_solves_match_jax(tmp_path):
    ranges, bank, cand = _affine_inputs(4, B=50, K=6)
    tiles = bank[np.maximum(cand, 0)]
    got = TA.affine_match_tiles(_t(ranges), _t(tiles), _t(np.maximum(cand, 0)).long(),
                                _t(cand < 0), objective="balanced")
    want = JA.affine_match_tiles(jnp.asarray(ranges), jnp.asarray(tiles),
                                 jnp.asarray(np.maximum(cand, 0)), jnp.asarray(cand < 0),
                                 objective="balanced")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close_to_energy(got[4].numpy(), np.asarray(want[4]), ranges)

    path = tmp_path / "bank.f32"
    bank.tofile(path)
    for domains in (bank, str(path)):
        for c in ([3, 17, -1, 40], [], None):
            got = TA.find_best_domain_affine(ranges[0], domains, c, range_size=4, device="cpu")
            want = JA.find_best_domain_affine(ranges[0], domains, c, range_size=4)
            assert got[0] == want[0] and got[3] == want[3]
            np.testing.assert_allclose(got[1:3], want[1:3], rtol=2e-5, atol=1e-2)
            _close_to_energy(np.array(got[4:]), np.array(want[4:]), ranges[:1])
    bad = tmp_path / "bad.f32"
    bad.write_bytes(b"\0" * 10)
    with pytest.raises(ValueError, match="multiple"):
        TA.find_best_domain_affine(ranges[0], str(bad), [0], range_size=4, device="cpu")
    got = TA.affine_solve_single(_t(ranges[1]), _t(bank[2]), device="cpu")
    want = JA.affine_solve_single(jnp.asarray(ranges[1]), jnp.asarray(bank[2]))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=2e-5)


# --- ops/search.py ----------------------------------------------------------------


@pytest.mark.parametrize("k,block", [(32, 256), (4, 64), (48, 32)])
def test_topk_scores_block_matches_jax(k, block):
    rng = _rng(k)
    q = rng.standard_normal((300, 16)).astype(np.float32)
    emb = rng.standard_normal((1024, 16)).astype(np.float32)
    valid = np.arange(1024) < 1000
    got = TS.topk_scores_block(_t(q), _t(emb), _t(valid), k, block)
    want = JS.topk_scores_block(jnp.asarray(q), jnp.asarray(emb), jnp.asarray(valid), k, block)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [32, 4, 40])
def test_merge_keeps_the_order_of_planted_ties(k):
    """Scores of 5 levels (so every block holds long runs of exact ties,
    and the same values recur in every block), some rows with fewer valid
    entries than k: the port's merge equals the JAX package's exactly,
    scores and indices, through both of its branches (k <= 8: max-extract;
    above: concat and lax.top_k) and through a block narrower than k."""
    M, block, n_blocks = 64, 32, 6
    rng = _rng(100 + k)
    score = (rng.integers(0, 5, (n_blocks, M, block)) / 4.0).astype(np.float32)
    score[:, ::9, :] = -np.inf
    score[1, ::9, 3] = 0.5             # rows with one valid entry in all
    score[2, 1::9, :30] = -np.inf
    got = TS._topk_merge_scan(lambda s: s, (_t(score),), M, k, block, n_blocks)
    want = JS._topk_merge_scan(lambda s: s, (jnp.asarray(score),), M, k, block, n_blocks)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy()[::9, 1:] == -1).all()


def test_stable_topk_orders_ties_by_position():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0, 1.0, 3.0]])
    vals, pos = TS._stable_topk(s, 3)
    assert vals.tolist() == [[3.0, 3.0, 3.0]] and pos.tolist() == [[1, 2, 4]]
    vals, pos = TS._stable_topk(s, 6)
    assert pos.tolist() == [[1, 2, 4, 5, 7, 3]]


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_exact_search_block_matches_jax(objective):
    rng = _rng(7)
    ranges = (rng.standard_normal((256, 4)) * 1000).astype(np.float32)
    bank = (rng.standard_normal((512, 4)) * 1000).astype(np.float32)
    valid = np.arange(512) < 500
    mean, denom = JA.affine_stats(jnp.asarray(bank))
    want = JS.exact_search_block(jnp.asarray(ranges), jnp.asarray(bank), mean, denom,
                                 jnp.asarray(valid), 128, 16.0, objective=objective,
                                 return_score=True)
    tmean, tdenom = TA.affine_stats(_t(bank))
    got = TS.exact_search_block(_t(ranges), _t(bank), tmean, tdenom, _t(valid), 128, 16.0,
                                objective=objective, return_score=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for k in (1, 2, 4, 5):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-5, atol=1e-3)


def test_topk_search_block_matches_jax():
    rng = _rng(8)
    ranges = (rng.standard_normal((512, 4)) * 1000).astype(np.float32)
    bank = (rng.standard_normal((2048, 4)) * 1000).astype(np.float32)
    valid = np.arange(2048) < 2000
    emb = TD.multi_head_embedding_batch(_t(bank))
    got = TS.topk_search_block(_t(ranges), _t(bank), emb, _t(valid), 32, 512, 16.0,
                               objective="balanced", return_score=True)
    want = JS.topk_search_block(jnp.asarray(ranges), jnp.asarray(bank),
                                JD.multi_head_embedding_batch(jnp.asarray(bank)),
                                jnp.asarray(valid), 32, 512, 16.0, objective="balanced",
                                return_score=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    _close_to_energy(got[5].numpy(), np.asarray(want[5]), ranges)


def test_reference_candidate_helpers_match_jax():
    rng = _rng(9)
    embs = rng.standard_normal((300, 16)).astype(np.float32)
    tile = rng.standard_normal(4).astype(np.float32)
    for top_k in (5, 32, 400):
        np.testing.assert_array_equal(
            TS.range_candidates_from_embedding(tile, embs, top_k=top_k, device="cpu"),
            JS.range_candidates_from_embedding(tile, embs, top_k=top_k))
    for idxs in (None, [], [3, 1], list(range(40))):
        np.testing.assert_array_equal(TS.pad_candidates(idxs, 8), JS.pad_candidates(idxs, 8))


# --- ops/index.py, ops/perceptual.py, ops/domains.py ------------------------------


def test_mips_index_file_and_queries_match_jax(tmp_path):
    rng = _rng(10)
    bank = rng.standard_normal((700, 4)).astype(np.float32)
    dom = tmp_path / "domains.f32"
    bank.tofile(dom)
    t_emb = TI.build_domain_embeddings(str(dom), 700, 4, tmpdir=tmp_path, device="cpu")
    j_emb = JI.build_domain_embeddings(str(dom), 700, 4, tmpdir=tmp_path)
    a = np.fromfile(t_emb, np.float32)
    b = np.fromfile(j_emb, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    t_idx = TI.build_ann_index(j_emb, 700, index_path=str(tmp_path / "t.ann"))
    j_idx = JI.build_ann_index(j_emb, 700, index_path=str(tmp_path / "j.ann"))
    assert (tmp_path / "t.ann").read_bytes() == (tmp_path / "j.ann").read_bytes()
    q = rng.standard_normal((20, 16)).astype(np.float32)
    for k in (8, 32, 1000):
        got = TI.MIPSIndex.load(t_idx).query(q, top_k=k, device="cpu")
        want = JI.MIPSIndex.load(j_idx).query(q, top_k=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TI.ann_query(bank[3], t_idx, device="cpu"),
                                  JI.ann_query(bank[3], j_idx))
    assert TI.ann_query(bank[3], None, device="cpu").size == 0
    assert TI.ann_query(bank[3], str(tmp_path / "missing.ann"), device="cpu").size == 0
    (tmp_path / "bad.ann").write_bytes(b"NOPE")
    with pytest.raises(ValueError, match="FWIX"):
        TI.MIPSIndex.load(tmp_path / "bad.ann")


def test_perceptual_ops_match_jax():
    for kw in ({}, dict(sr=16000, n_fft=512, n_mels=20, fmin=50, fmax=7000)):
        np.testing.assert_array_equal(TP.mel_filterbank(**kw), JP.mel_filterbank(**kw))
    np.testing.assert_array_equal(TP.get_mel_filterbank(), JP.get_mel_filterbank())
    rng = _rng(11)
    sig = rng.standard_normal(3000).astype(np.float32)
    np.testing.assert_array_equal(TP.compute_transient_mask(sig), JP.compute_transient_mask(sig))
    tiles = rng.standard_normal((9, 16)).astype(np.float32)
    target = rng.standard_normal(16).astype(np.float32)
    mask = rng.random(16).astype(np.float32)
    for kw in ({}, dict(transient_mask=mask, transient_weight=0.5),
               dict(mel_fb=np.linspace(1, 2, 16))):
        np.testing.assert_allclose(TP.perceptual_error_batch(tiles, target, device="cpu", **kw).numpy(),
                                   np.asarray(JP.perceptual_error_batch(tiles, target, **kw)),
                                   rtol=1e-5)
    bank = rng.standard_normal((40, 16)).astype(np.float32)
    r = bank[7] * 1.3 + 0.2 + rng.standard_normal(16).astype(np.float32) * 0.01
    for cand in ([7, 3, -1, 12], [-1, -1], list(range(40))):
        got = TP.pruned_affine_search(r, cand, bank, device="cpu")
        want = [np.asarray(x).item() for x in JP.pruned_affine_search(r, cand, bank)]
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_allclose(got[1:3] + got[4:], want[1:3] + want[4:], rtol=1e-4)


def test_domain_helpers_are_copies():
    sig = _rng(12).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(TDom.build_domains_np(sig, 1024, 4, 2),
                                  JDom.build_domains_np(sig, 1024, 4, 2))
    assert TDom.build_domains_np(sig[:100], 1024, 4).shape == (0, 4)
    np.testing.assert_array_equal(TDom.frame_ranges(sig, 4, 3), JDom.frame_ranges(sig, 4, 3))
    assert TDom.frame_ranges(sig[:2], 4).shape == (0, 4)
    for a, b in zip(TDom.apply_symmetry(sig[:4]), JDom.apply_symmetry(sig[:4])):
        np.testing.assert_array_equal(a, b)


# --- the encode ---------------------------------------------------------------------


def _selection64(sig, n, bank, idx, rows, objective="balanced", s_clip=16.0):
    """float64 selection score of ops/affine.py's shortlist solve (balanced:
    the affine residual plus the default decoder's offset penalty; damped:
    the residual of the clipped scale; the better orientation) of bank
    rows idx for the raw ranges `rows`, and the ranges' centered energy."""
    pad = (-len(sig)) % n
    r = np.pad(sig, (0, pad), mode="reflect").reshape(-1, n)[rows].astype(np.float64)
    rc = r - r.mean(1, keepdims=True)
    t = bank[idx].astype(np.float64)
    tm = t.mean(1)
    tc = t - tm[:, None]
    den = (tc * tc).sum(1) + 1e-12
    r_e = (rc * rc).sum(1)
    out = []
    for rr in (rc, rc[:, ::-1]):
        num = (rr * tc).sum(1)
        if objective == "damped":
            s_cl = np.clip(num / den, -s_clip, s_clip)
            out.append(r_e - 2 * s_cl * num + s_cl * s_cl * den)
        else:
            out.append(r_e - num * num / den + n * (num / den * tm) ** 2)
    return np.minimum(*out), r_e


def assert_topk_bar(sig, J, T, decode_kw=None, objective="balanced"):
    """The topk encode bar (module doc) of a port result T against the JAX
    result J of the same signal; returns the count of differing rows that
    are not exact ties."""
    rec_j, bank_j, n_ranges, n, *_ = J
    rec_t, bank_t, *_ = T
    assert tuple(J[2:]) == tuple(T[2:])
    np.testing.assert_array_equal(bank_t, bank_j)
    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    assert (rec_t["idx"] >= 0).any()
    diff = np.nonzero(rec_t["idx"] != rec_j["idx"])[0]
    a, r_e = _selection64(sig, n, bank_j, rec_t["idx"][diff], diff, objective)
    b, _ = _selection64(sig, n, bank_j, rec_j["idx"][diff], diff, objective)
    gap = np.abs(a - b)
    near = gap > EXACT_TIE_RTOL * r_e  # the rest are exact ties of the selection
    assert near.sum() <= near_tie.allowed_diffs(n_ranges), (near.sum(), len(diff))
    assert (gap <= TOPK_RTOL_OF_ENERGY * r_e).all(), (a, b, r_e)
    same = rec_t["idx"] == rec_j["idx"]
    np.testing.assert_array_equal(rec_t[same].view(np.uint8), rec_j[same].view(np.uint8))
    kw = decode_kw or {}
    snr_j = compute_snr(sig, jax_decode(rec_j, bank_j, n_ranges, n, original_len=J[7], **kw))
    snr_t = compute_snr(sig, port.decompress_audio(rec_t, bank_t, n_ranges, n,
                                                   original_len=T[7], device="cpu", **kw))
    assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)
    return int(near.sum())


def _stack():
    """bench.make_signal(1.0) and two scaled, dithered copies: three
    16-bit files of one shape bucket (chip_smoke.packed_signals' recipe)."""
    base = bench.make_signal(1.0)
    out = [base]
    for k in (1, 2):
        rng = _rng(50 + k)
        out.append(np.round(base * (0.6 + 0.4 * rng.random())
                            + rng.normal(0, 20, len(base))).astype(np.float32))
    return out


def _encode_topk(i, **kw):
    if i not in _CACHE:
        sig = _stack()[i]
        _CACHE[i] = (sig, jax_encode(sig, 44100, 2, search="topk", **kw),
                     port.compress_audio_arrays(sig, 44100, 2, search="topk", device="cpu", **kw))
    return _CACHE[i]


def test_topk_encode_matches_jax():
    sig, J, T = _encode_topk(0)
    kernels.reset_launch_counts()
    port.compress_audio_arrays(sig[:20000], 44100, 2, search="topk", device="cpu")
    assert not any(kernels.LAUNCHES.values())
    assert assert_topk_bar(sig, J, T) <= 4  # measured: 2 of 11,025


def test_topk_packed_stack_equals_single_encodes():
    sigs = _stack()
    packed = port.compress_audio_packed(sigs, 44100, 2, search="topk", device="cpu")
    for i, sig in enumerate(sigs):
        one = _encode_topk(0)[2] if i == 0 else port.compress_audio_arrays(
            sig, 44100, 2, search="topk", device="cpu")
        assert packed[i][0].tobytes() == one[0].tobytes(), i
        np.testing.assert_array_equal(packed[i][1], one[1])
        assert tuple(packed[i][2:]) == tuple(one[2:])
    assert_topk_bar(sigs[0], _encode_topk(0)[1], packed[0])


def test_topk_stream_shards_match_jax(speechlike):
    """search="topk" in every masked shard of the streaming encoder (tile
    128, shards of 4,096 samples with 2,048 of halo, on the speechlike
    fixture), default and damped, under the full bar with the damped
    profile's global pass off. Its differing rows are exact ties at the
    edge of the fixture's first silent gap. With the pass on (the damped
    default) such a tie changes the local winner that the pass compares its
    nomination against, so the pass may keep another row: measured 30 of
    4,000 rows and 0.0058 dB, held here to the sentinel set and the SNR."""
    sig, sr, _ = speechlike
    bank = TDom.build_domains_host(sig, 128, 4, 1)
    for objective, extra in (("balanced", {}), ("damped", {"global_candidates": False}),
                             ("damped", {})):
        kw = dict(tile_size=128, shard_samples=4096, halo=2048, search="topk",
                  objective=objective, **extra)
        J = jax_stream(sig, sr, 2, **kw)
        T = port.compress_audio_streaming(sig, sr, 2, device="cpu", **kw)
        J, T = (J[0], bank, *J[2:]), (T[0], bank, *T[2:])
        decode = {"s_damping": 0.25} if objective == "damped" else {}
        if extra or objective == "balanced":
            assert assert_topk_bar(sig, J, T, decode, objective) == 0
            continue
        np.testing.assert_array_equal(T[0]["idx"] < 0, J[0]["idx"] < 0)
        snr_j = compute_snr(sig, jax_decode(J[0], bank, J[2], 4, original_len=J[7], **decode))
        snr_t = compute_snr(sig, port.decompress_audio(T[0], bank, T[2], 4,
                                                       original_len=T[7], device="cpu",
                                                       **decode))
        assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)


def test_auto_never_picks_topk_and_the_plan_takes_it():
    for db in (512, 45056, 450560):
        assert port_encode._plan_search(EncoderConfig(), 4096, db)[0] != "topk"
    assert port_encode._plan_search(EncoderConfig(search="topk"), 4096, 45056) == (
        "topk", 128, None)


@pytest.mark.slow
def test_topk_constants_of_chip_smoke(tmp_path):
    """chip_smoke.TOPK from the JAX CLI's CPU run at 10 s (about 4 min; the
    derivation of scripts/derive_topk_constants.py)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "derive_topk_constants",
        Path(__file__).resolve().parent.parent / "scripts" / "derive_topk_constants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from fwav_tpu import cli as jax_cli
    from fwav_tpu_torch.io.wav import write_wav

    wav = tmp_path / "bench10.wav"
    write_wav(wav, bench.make_signal(chip_smoke.TOPK["seconds"]), 44100, 2)
    rec, snr, _ = mod.run_cli(jax_cli.main, wav, tmp_path / "jax.fwav")
    assert len(rec) == chip_smoke.TOPK["n_ranges"]
    assert int((rec["idx"] < 0).sum()) == chip_smoke.TOPK["sentinels"]
    assert round(float(snr), 4) == chip_smoke.TOPK["snr_db"]


def test_dataclass_configs_are_copies():
    import fwav_tpu.config as jc

    assert dataclasses.asdict(port.VADConfig()) == dataclasses.asdict(jc.VADConfig())
    assert port.EMBED_K == jc.EMBED_K
