"""The port's IVF module (index/ivf.py) against the JAX reference's, on the
CPU: one port case for each case of tests/test_ivf.py, and parity.

Parity: k-means on clustered data gives centroids within 1e-6 of the
reference's and equal assignments (the two CPU backends sum f32 products
in different orders, so not bitwise); the host assignment passes
(``balanced_assign``, ``spill_assign``) are the reference's numpy and give
equal arrays; the cluster-sorted slab has the reference's row map, cap and
cluster count. The probe rescore is K2 (its plain twin here), held to the
reference's K2 in interpret mode at 1e-6 (f32 sum order); the reference's
own off-TPU probe takes an f32-query einsum, and that divergence is
measured and bounded below.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.index import ivf as rivf
from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu_torch.core.errors import InvalidConfig
from frankensearch_tpu_torch.index import ivf as pivf
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.recall_certificate import calibrate_minimal_parameter, per_query_recall
from frankensearch_tpu_torch.ops import topk_scan as tts
from tests.conftest import make_unit_rows

CPU = torch.device("cpu")
F32 = torch.float32


def clustered_corpus(rng, n_clusters=8, per_cluster=64, d=64, spread=0.25):
    centers = make_unit_rows(rng, n_clusters, d)
    x = np.concatenate([c[None, :] + spread * rng.standard_normal((per_cluster, d)).astype(np.float32)
                        for c in centers])
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def exact_indices(x, q, k):
    return tts.scan_topk_xla(torch.from_numpy(x), torch.from_numpy(q), k, precise=True).indices.numpy()


# --------------------------------------------------------------------------
# tests/test_ivf.py, case for case
# --------------------------------------------------------------------------


class TestKmeans:
    def test_centroids_unit_norm(self, rng):
        c = pivf.kmeans(clustered_corpus(rng), 8, iters=5, device=CPU)
        np.testing.assert_allclose(np.linalg.norm(c, axis=1), 1.0, atol=1e-5)

    def test_balanced_assign_respects_cap(self, rng):
        x = clustered_corpus(rng, n_clusters=4, per_cluster=50)
        assign = pivf.balanced_assign(x, pivf.kmeans(x, 4, iters=5, device=CPU), 80)
        counts = np.bincount(assign, minlength=4)
        assert counts.max() <= 80 and counts.sum() == len(x)


class TestIvfSearch:
    def test_high_recall_on_clustered_data(self, rng):
        x = clustered_corpus(rng)
        ivf = pivf.IvfIndex(x, pivf.IvfParams(n_clusters=16, seed=1), dtype=F32, device=CPU)
        queries = x[::37][:8] + 0.05 * rng.standard_normal((8, 64)).astype(np.float32)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        approx = ivf.search_batch(queries, k=10, nprobe=4)
        assert per_query_recall(approx.indices.numpy(), exact_indices(x, queries, 10)).mean() >= 0.85
        assert ivf.scanned_fraction(nprobe=4) < 0.6

    def test_full_probe_is_exact(self, rng):
        x = clustered_corpus(rng, n_clusters=4, per_cluster=32)
        ivf = pivf.IvfIndex(x, pivf.IvfParams(n_clusters=8, seed=2), dtype=F32, device=CPU)
        approx = ivf.search_batch(x[:4], k=5, nprobe=ivf.n_clusters).indices.numpy()
        exact = exact_indices(x, x[:4], 5)
        for b in range(4):
            assert set(approx[b]) == set(exact[b])

    def test_nprobe_calibration_with_certificate(self, rng):
        x = clustered_corpus(rng)
        ivf = pivf.IvfIndex(x, pivf.IvfParams(n_clusters=16, seed=3), dtype=F32, device=CPU)
        queries = make_unit_rows(rng, 40, 64) * 0.3 + x[::13][:40] * 0.7
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        cert = calibrate_minimal_parameter(
            lambda v: ivf.search_batch(queries, 10, nprobe=int(v)).indices.numpy(),
            exact_indices(x, queries, 10), [2, 4, 8, 16],
            parameter_name="nprobe", k=10, target_recall=0.8, confidence=0.9,
        )
        assert cert is not None and cert.certified_recall >= 0.8


class TestIvfDeviceIndex:
    def test_recall_vs_exact(self, rng):
        x = make_unit_rows(rng, 4096, 64)
        ivf = pivf.IvfDeviceIndex(x, n_clusters=32, dtype=F32, seed=3, device=CPU)
        queries = make_unit_rows(rng, 8, 64)
        ri, xi = ivf.search_batch(queries, k=10, nprobe=8).indices.numpy(), exact_indices(x, queries, 10)
        assert np.mean([len(set(ri[b]) & set(xi[b])) / 10 for b in range(8)]) >= 0.7
        rf = ivf.search_batch(queries, k=10, nprobe=32).indices.numpy()  # full probe == exact
        for b in range(8):
            assert set(rf[b]) == set(xi[b])

    def test_row_mapping_and_padding(self, rng):
        x = make_unit_rows(rng, 300, 32)  # intra-bucket padding
        ivf = pivf.IvfDeviceIndex(x, n_clusters=4, dtype=F32, device=CPU)
        idx = ivf.search_batch(make_unit_rows(rng, 4, 32), k=20, nprobe=4).indices.numpy()
        valid = idx[idx >= 0]
        assert len(valid) > 0 and valid.max() < 300  # padded slots never surface

    def test_planted_neighbor(self, rng):
        x = make_unit_rows(rng, 2048, 32) * 0.3
        q = make_unit_rows(rng, 1, 32)
        x[777] = q[0]
        ivf = pivf.IvfDeviceIndex(x, n_clusters=16, dtype=F32, seed=1, device=CPU)
        assert ivf.search_batch(q, k=5, nprobe=4).indices.numpy()[0, 0] == 777

    def test_scanned_fraction_scales_with_nprobe(self, rng):
        ivf = pivf.IvfDeviceIndex(make_unit_rows(rng, 4096, 32), n_clusters=32, dtype=F32, device=CPU)
        assert ivf.scanned_fraction(4) < ivf.scanned_fraction(16) <= 1.5
        assert ivf.scanned_fraction(4) < 0.35

    def test_spill_assign_respects_cap(self):
        assign = pivf.spill_assign(np.array([[0, 1]] * 4), np.array([0.9, 0.5, 0.8, 0.1]), n_clusters=2, cap=2)
        counts = np.bincount(assign, minlength=2)
        assert (counts <= 2).all() and counts.sum() == 4

    def test_dim_padded_for_the_rescore(self, rng):
        """A dim that is not a multiple of 8 is padded with zero columns
        (K2's 16-byte loads); the scores are the unpadded dots."""
        x = make_unit_rows(rng, 600, 20)
        ivf = pivf.IvfDeviceIndex(x, n_clusters=4, dtype=F32, device=CPU)
        assert ivf.slab.shape[1] == 24 and ivf.dim == 20
        q = make_unit_rows(rng, 3, 20)
        res = ivf.search_batch(q, k=5, nprobe=4)
        np.testing.assert_allclose(res.scores.numpy(), np.take_along_axis(q @ x.T, res.indices.numpy(), 1),
                                   rtol=1e-6, atol=1e-6)


def _index(x, **kw):
    ident = EmbeddingIdentity(embedder_id="t", embedder_revision="r", dim=x.shape[1])
    return DeviceVectorIndex(x, [f"d{i}" for i in range(len(x))], ident, device=CPU, slab_dtype="f32", **kw)


class TestIvfArmInDeviceIndex:
    def test_mode_ivf_with_tombstones_and_filters(self, rng):
        x = make_unit_rows(rng, 1024, 32)
        q = make_unit_rows(rng, 4, 32)
        x[500] = q[0]  # planted best hit
        x[501] = q[0] * 0.99 + x[501] * 0.01  # runner-up
        tomb = np.zeros(1024, dtype=bool)
        tomb[500] = True  # tombstone the best hit
        index = _index(x, tombstoned=tomb)
        with pytest.raises(InvalidConfig):
            index.search_batch(q, 5, mode="ivf")  # arm not built yet
        index.enable_ivf(n_clusters=8, dtype=F32, seed=0)
        res = index.search_batch(q, 5, mode="ivf", nprobe=8)
        idx = res.indices.numpy()
        assert 500 not in idx[0] and (idx[idx >= 0] < 1024).all()
        hits = index.hydrate(res)[0]
        assert hits and hits[0].doc_id.startswith("d")

    def test_append_invalidates_arm(self, rng):
        index = _index(make_unit_rows(rng, 256, 32))
        index.enable_ivf(n_clusters=4, dtype=F32)
        index.search_batch(make_unit_rows(rng, 2, 32), 3, mode="ivf")  # works
        index2 = index.with_appended(["new"], make_unit_rows(rng, 1, 32))
        with pytest.raises(InvalidConfig):
            index2.search_batch(make_unit_rows(rng, 2, 32), 3, mode="ivf")
        index2.enable_ivf(n_clusters=4, dtype=F32)  # rebuilt over the new rows, it serves again
        assert index2.hydrate(index2.search_batch(index2.vectors_f32()[-1:], 1, mode="ivf", nprobe=4))[0][0].doc_id == "new"

    def test_calibrate_nprobe_certificate(self, rng):
        centers = make_unit_rows(rng, 32, 32)
        x = centers[rng.integers(0, 32, size=2048)] + 0.05 * rng.standard_normal((2048, 32)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        queries = centers[rng.integers(0, 32, size=32)] + 0.05 * rng.standard_normal((32, 32)).astype(np.float32)
        queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        ivf = pivf.IvfDeviceIndex(x, n_clusters=32, dtype=F32, seed=0, device=CPU)
        cert = pivf.calibrate_nprobe(ivf, queries, exact_indices(x, queries, 10), k=10,
                                     target_recall=0.8, confidence=0.9)
        assert cert is not None and cert.parameter_name == "nprobe"
        assert cert.certified_recall >= 0.8 and cert.parameter_value <= 32

    @pytest.mark.parametrize("mode,kw", [("ivf", {"nprobe": 4}), ("mrl", {"mrl_search_dims": 16})])
    def test_certify_scan_mode_records_the_lane(self, rng, mode, kw):
        """``certify_scan_mode`` measures the IVF and MRL lanes against the
        exact scan and records a certificate under the mode, named after
        the lane's parameter."""
        x = clustered_corpus(rng, d=32)
        index = _index(x)
        index.enable_ivf(n_clusters=8, dtype=F32)
        cert = index.certify_scan_mode(mode, 10, x[::9][:24], **kw)
        assert index.recall_certificate(mode) is cert
        assert cert.parameter_name == next(iter(kw)) and cert.parameter_value == next(iter(kw.values()))
        assert 0.0 < cert.mean_recall <= 1.0


class TestScanModeConfig:
    def test_env_override_and_validation(self, monkeypatch):
        from frankensearch_tpu_torch.core.config import TwoTierConfig

        monkeypatch.setenv("FRANKENSEARCH_SCAN_MODE", "ivf")
        monkeypatch.setenv("FRANKENSEARCH_IVF_NPROBE", "4")
        cfg = TwoTierConfig.from_env()
        assert cfg.scan_mode == "ivf" and cfg.ivf_nprobe == 4
        with pytest.raises(InvalidConfig):
            TwoTierConfig(scan_mode="warp").validate()
        with pytest.raises(InvalidConfig):
            TwoTierConfig(ivf_nprobe=0).validate()

    def test_searcher_uses_ivf_lane(self, tmp_path):
        from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig
        from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
        from frankensearch_tpu_torch.index.two_tier import TwoTierIndex

        fe = HashEmbedder(dim=64)
        texts = [f"document number {i} about topic {i % 7}" for i in range(64)]
        index = TwoTierIndex.create(str(tmp_path / "v"), fe.embed_batch(texts), [f"d{i:03d}" for i in range(64)],
                                    fe.identity(), device=CPU, slab_dtype="f32")
        index.fast.enable_ivf(n_clusters=4, dtype=F32)
        s = TwoTierSearcher(index, fe, config=TwoTierConfig(scan_mode="ivf", ivf_nprobe=4),
                            cache_query_embeddings=False)
        out = s.search("document number 12 about topic", k=5)
        assert out.results
        s2 = TwoTierSearcher(index, fe, config=TwoTierConfig(scan_mode="auto"), cache_query_embeddings=False)
        out2 = s2.search("document number 12 about topic", k=5)
        assert {r.doc_id for r in out.results} & {r.doc_id for r in out2.results}


class TestIncrementalArms:
    def test_int8_arm_survives_fast_append(self, rng):
        index = _index(make_unit_rows(rng, 512, 32))
        index._int8_arm()
        planted = make_unit_rows(rng, 1, 32)
        idx2 = index.with_appended(["fresh"], planted)
        assert idx2._int8 is not None  # carried incrementally
        assert idx2.hydrate(idx2.search_batch(planted, 3, mode="int8"))[0][0].doc_id == "fresh"
        assert index.n_rows == 512 and index._int8 is not None  # the original is untouched


class TestDegenerateCorpora:
    def test_tiny_corpus_clamps_to_single_cluster(self):
        v = np.random.default_rng(0).standard_normal((2, 32)).astype(np.float32)
        ivf = pivf.IvfIndex(v, pivf.IvfParams(n_clusters=16, seed=1), dtype=F32, device=CPU)
        ids = ivf.search_batch(v[:1], k=2, nprobe=4).indices.numpy()[0].tolist()
        assert ids[0] == 0 and set(ids) == {0, 1}
        one = pivf.IvfIndex(v[:1], pivf.IvfParams(n_clusters=4), dtype=F32, device=CPU)
        assert one.search_batch(v[:1], k=3, nprobe=2).indices.numpy()[0].tolist()[0] == 0


# --------------------------------------------------------------------------
# parity with the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = clustered_corpus(rng, n_clusters=12, per_cluster=80)
    want = rivf.kmeans(x, 12, iters=10, seed=seed)
    got = pivf.kmeans(x, 12, iters=10, seed=seed, device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(np.argmax(x @ got.T, axis=1), np.argmax(x @ want.T, axis=1))


def test_kmeans_subsample_matches_reference():
    """Above ``train_sample`` both draw the same numpy-seeded subsample."""
    x = clustered_corpus(np.random.default_rng(4), n_clusters=6, per_cluster=100)
    want = rivf.kmeans(x, 6, iters=4, seed=3, train_sample=250)
    np.testing.assert_allclose(pivf.kmeans(x, 6, iters=4, seed=3, train_sample=250, device=CPU), want, atol=1e-6)


def test_host_assignments_match_reference():
    rng = np.random.default_rng(7)
    x = clustered_corpus(rng, n_clusters=6, per_cluster=60)
    cents = rivf.kmeans(x, 6, iters=5)
    np.testing.assert_array_equal(pivf.balanced_assign(x, cents, 70), rivf.balanced_assign(x, cents, 70))
    prefs = rng.integers(0, 9, size=(500, 4))
    margins = np.round(rng.random(500), 2)  # ties: the stable order decides
    np.testing.assert_array_equal(pivf.spill_assign(prefs, margins, 9, 60), rivf.spill_assign(prefs, margins, 9, 60))
    got_p, got_m = pivf._prefs_device(x, cents, device=CPU, chunk=100)
    want_p, want_m = rivf._prefs_device(x, cents, chunk=100)
    np.testing.assert_array_equal(got_p, np.asarray(want_p))
    np.testing.assert_allclose(got_m, np.asarray(want_m), atol=1e-6)


@pytest.mark.parametrize("n,c,slack", [(3000, 12, 1.5), (2048, None, 1.5), (700, 5, 1.1)])
def test_sorted_slab_matches_reference(n, c, slack):
    rng = np.random.default_rng(n)
    x = clustered_corpus(rng, n_clusters=10, per_cluster=n // 10, d=32)
    ref = rivf.IvfDeviceIndex(x, c, dtype=jnp.float32, capacity_slack=slack)
    port = pivf.IvfDeviceIndex(x, c, dtype=F32, capacity_slack=slack, device=CPU)
    assert (port.n_clusters, port.cap, port.groups_per_cluster) == (ref.n_clusters, ref.cap, ref.groups_per_cluster)
    np.testing.assert_array_equal(port.row_map, ref._row_map)
    np.testing.assert_array_equal(port.slab.numpy(), np.asarray(ref.slab))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    q = make_unit_rows(rng, 8, 32)
    for nprobe in (1, 3, port.n_clusters):
        got, want = port.search_batch(q, 10, nprobe=nprobe), ref.search_batch(q, 10, nprobe=nprobe)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-6)


def test_ivf_index_matches_reference():
    rng = np.random.default_rng(9)
    x = clustered_corpus(rng, n_clusters=8, per_cluster=40)
    ref = rivf.IvfIndex(x, rivf.IvfParams(n_clusters=8, seed=1), dtype=jnp.float32)
    port = pivf.IvfIndex(x, pivf.IvfParams(n_clusters=8, seed=1), dtype=F32, device=CPU)
    np.testing.assert_array_equal(port.bucket_rows.numpy(), np.asarray(ref.bucket_rows))
    q = make_unit_rows(rng, 5, 64)
    got, want = port.search_batch(q, 7, nprobe=3), ref.search_batch(q, 7, nprobe=3)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-6)


def test_ivf_probe_rescore_matches_reference_kernel():
    """The probe's rescore is K2 (its twin here) on the probed groups: the
    reference's K2 in interpret mode on the same sorted group ids gives
    the same scores (1e-6, f32 sum order), with the query rounded to the
    slab dtype."""
    rng = np.random.default_rng(3)
    x = make_unit_rows(rng, 2048, 64)
    port = pivf.IvfDeviceIndex(x, n_clusters=8, device=CPU, seed=1)
    q = make_unit_rows(rng, 8, 64)
    qt = torch.from_numpy(q)
    _, probe = tts.topk_desc_rowasc(qt @ port.centroids.T, 3)
    gpc = port.groups_per_cluster
    gids = (probe[:, :, None] * gpc + torch.arange(gpc)).reshape(8, -1).sort(dim=1).values.to(torch.int32)
    got = tts.gather_rescore(port.slab, qt, gids)
    slab_j = jnp.asarray(port.slab.to(torch.float32).numpy(), jnp.bfloat16)
    want = jts._gather_rescore_pallas(slab_j, jnp.asarray(q), jnp.asarray(gids.numpy()), group=128,
                                      kk=gids.shape[1], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert port.slab.dtype == torch.bfloat16  # the reference's default arm dtype


def test_ivf_f32_query_divergence_is_bounded():
    """Off its TPU the reference probes with an f32-query einsum; the port's
    K2 rounds the query to the arm's dtype (bf16 here). Each score then
    moves by at most ||q - bf16(q)|| <= 2^-9 for unit rows (Cauchy-Schwarz,
    round-to-nearest), and the rows agree wherever no two candidates lie
    closer than that."""
    rng = np.random.default_rng(11)
    x = make_unit_rows(rng, 3000, 64)
    q = make_unit_rows(rng, 8, 64)
    ref = rivf.IvfDeviceIndex(x, n_clusters=12, seed=2)
    port = pivf.IvfDeviceIndex(x, n_clusters=12, device=CPU, seed=2)
    np.testing.assert_array_equal(port.row_map, ref._row_map)
    for nprobe in (2, 12):
        want = ref.search_batch(q, 10, nprobe=nprobe)
        got = port.search_batch(q, 10, nprobe=nprobe)
        gs, ws = got.scores.numpy(), np.asarray(want.scores)
        gap = np.abs(gs - ws).max()
        assert gap <= 2.0 ** -9, gap
        assert gap > 0  # the rounding is real: this is a divergence, not noise
        gi, wi = got.indices.numpy(), np.asarray(want.indices)
        for b in range(8):
            for j in np.flatnonzero(gi[b] != wi[b]):
                assert np.min(np.abs(ws[b] - gs[b, j])) <= 2.0 ** -8, (b, j)
