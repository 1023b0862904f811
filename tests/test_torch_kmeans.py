"""The port's minibatch spherical k-means against the JAX package's on the
CPU (synthesis_in_style_tpu_torch/segmentation/kmeans.py vs
synthesis_in_style_tpu/segmentation/kmeans.py).

JAX's random streams cannot be reproduced in torch, so the deterministic
parts are held exactly or to float32 rounding, and the seeded fit by
quality:

* one minibatch step on the same centres, counts and batch: centres,
  counts, inertia and squared movement within 1e-5 (float32 products
  summed in another order);
* the starved-centre reassignment given the indices JAX draws: equal;
* a whole fit with both sides' initial centres and permutations replaced by
  the same arrays: the same step count, centres within 1e-5;
* the seeded fits on blobs: inertia within 2 %, adjusted Rand index of
  their labels >= 0.95.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.segmentation import kmeans as jk
from synthesis_in_style_tpu.segmentation.ptutils import partial_flat as jax_partial_flat
from synthesis_in_style_tpu.segmentation.ptutils import partial_unflat as jax_partial_unflat
from synthesis_in_style_tpu_torch.segmentation import kmeans as tk
from synthesis_in_style_tpu_torch.segmentation.ptutils import partial_flat, partial_unflat
from torch_threads import one_torch_thread  # noqa: F401


def _blobs(n_per, k, dim, scale, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim))
    x = np.concatenate([c + scale * rng.normal(size=(n_per, dim)) for c in centers])
    labels = np.repeat(np.arange(k), n_per)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), labels[perm]


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _adjusted_rand_index(a, b):
    """Hubert-Arabie adjusted Rand index of two labelings."""
    _, a = np.unique(a, return_inverse=True)
    _, b = np.unique(b, return_inverse=True)
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)

    def pairs(v):
        return (v * (v - 1) / 2).sum()

    index = pairs(table)
    rows, cols = pairs(table.sum(1)), pairs(table.sum(0))
    expected = rows * cols / pairs(np.array([len(a)]))
    return (index - expected) / ((rows + cols) / 2 - expected)


def _pad(a, k_pad):
    out = np.zeros((k_pad,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def _step_inputs(k=5, b=64, dim=16, seed=0, counts=None):
    rng = np.random.default_rng(seed)
    centers = _normalize(rng.normal(size=(k, dim))).astype(np.float32)
    centers[-1] = -centers[0]  # far from the data's mode: few or no points
    batch = (centers[0] + 0.8 * rng.normal(size=(b, dim))).astype(np.float32)
    if counts is None:
        counts = rng.integers(0, 50, size=k).astype(np.float32)
    return centers, np.asarray(counts, np.float32), batch


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "jax_padded_to_8"])
@pytest.mark.parametrize("counts", [None, [0, 0, 0, 0, 0]], ids=["counts", "fresh"])
def test_minibatch_step_matches_jax(padded, counts):
    centers, cnt, batch = _step_inputs(counts=counts)
    k = len(centers)
    if padded:
        valid = jk._valid_mask(8, jnp.int32(k))
        j_in = (jnp.asarray(_pad(centers, 8)), jnp.asarray(_pad(cnt, 8)))
    else:
        valid, j_in = None, (jnp.asarray(centers), jnp.asarray(cnt))
    jc, jn, ji, jd = jk._minibatch_step(*j_in, jnp.asarray(batch), jnp.asarray(False),
                                       jax.random.PRNGKey(0), 0.01, valid)
    tc, tn, ti, td = tk._minibatch_step(torch.from_numpy(centers), torch.from_numpy(cnt),
                                        torch.from_numpy(batch), False, None, 0.01)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[:k], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn)[:k])
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5, atol=1e-7)


def test_minibatch_step_with_reassignment_matches_jax():
    """The step with do_reassign true, fed the rows JAX's key draws."""
    centers, cnt, batch = _step_inputs(counts=[500, 40, 3, 0, 1])
    key = jax.random.PRNGKey(3)
    new_idx = np.array(jax.random.choice(key, batch.shape[0], (len(centers),), replace=False))
    jc, jn, ji, jd = jk._minibatch_step(jnp.asarray(centers), jnp.asarray(cnt),
                                       jnp.asarray(batch), jnp.asarray(True), key, 0.01)
    for do_reassign in (True, torch.tensor(True)):
        tc, tn, ti, td = tk._minibatch_step(
            torch.from_numpy(centers), torch.from_numpy(cnt), torch.from_numpy(batch),
            do_reassign, torch.from_numpy(new_idx), 0.01)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
        np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)


REASSIGN_CASES = {
    # k, B, counts
    "one_starved": (5, 16, [100, 40, 0, 80, 60]),
    # 6 starved, cap B // 2 = 3, ties among the zero counts broken by index
    "over_cap_with_ties": (8, 6, [0, 0, 3, 0, 0, 5, 600, 1000]),
    "none_starved": (4, 8, [10, 12, 9, 11]),
    # k > B: JAX draws with replacement
    "more_centres_than_rows": (8, 4, [0, 7, 0, 900, 2, 0, 0, 50]),
}


@pytest.mark.parametrize("case", sorted(REASSIGN_CASES))
def test_reassign_starved_matches_jax(case):
    k, b, counts = REASSIGN_CASES[case]
    rng = np.random.default_rng(1)
    centers = _normalize(rng.normal(size=(k, 8))).astype(np.float32)
    xb = _normalize(rng.normal(size=(b, 8))).astype(np.float32)
    counts = np.asarray(counts, np.float32)
    key = jax.random.PRNGKey(7)
    new_idx = np.array(jax.random.choice(key, b, (k,), replace=k > b))
    jc, jn = jk._reassign_starved(jnp.asarray(centers), jnp.asarray(counts), jnp.asarray(xb),
                                  key, 0.01)
    tc, tn = tk._reassign_starved(torch.from_numpy(centers), torch.from_numpy(counts),
                                  torch.from_numpy(xb), torch.from_numpy(new_idx), 0.01)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    if case == "over_cap_with_ties":
        moved = (tc.numpy() != centers).any(axis=1)
        assert moved.tolist() == [True, True, False, True, False, False, False, False]


FIT_CASES = {
    # n, batch size, epochs, max_no_improvement, tol; with one batch per
    # epoch the fit runs to its cap: its inertia converges, and a stop would
    # then be decided by float32 rounding
    "batch_covers_data": (500, 1024, 8, 2, 0.0),
    "wrapping_batches": (2000, 300, 3, 3, 0.0),
    "tol_rule": (2000, 300, 3, 10, 1e-2),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_with_injected_draws_matches_jax(case, monkeypatch):
    """Both fits start from the same centres and walk the same permutations
    (reassignment off): the same steps, centres within 1e-5."""
    n, bs, epochs, mni, tol = FIT_CASES[case]
    k = 5
    x, _ = _blobs(n // k, k, 16, 0.6, seed=2)
    rng = np.random.default_rng(4)
    init = _normalize(x[rng.choice(n, k, replace=False)]).astype(np.float32)
    perms = [rng.permutation(n) for _ in range(epochs)]

    jax_perms = iter(perms)
    monkeypatch.setattr(jk, "_kmeanspp_init",
                        lambda sub, key, k_pad, k_valid: jnp.asarray(_pad(init, k_pad)))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, m: jnp.asarray(next(jax_perms)))
    # the port draws its init subsample first, then one permutation per epoch
    port_perms = iter([np.arange(n)] + perms)
    monkeypatch.setattr(tk, "_kmeanspp_init", lambda sub, u, kk: torch.from_numpy(init))
    monkeypatch.setattr(tk, "_permutation", lambda m, g: torch.from_numpy(next(port_perms)))

    kwargs = dict(batch_size=bs, n_epochs=epochs, max_no_improvement=mni, tol=tol,
                  reassignment_ratio=0.0)
    j = jk.MiniBatchSphericalKMeans(k, **kwargs).fit(x)
    t = tk.MiniBatchSphericalKMeans(k, **kwargs).fit(torch.from_numpy(x))
    assert t.n_steps_ == j.n_steps_
    if bs < n:
        assert j.n_steps_ < epochs * -(-n // bs)  # the stopping rule ended the fit
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t._counts, j._counts)


def test_fit_with_reassignment_and_injected_draws_matches_jax(monkeypatch):
    """Reassignment on: the same fixed centres and permutations, and the
    port fed the rows JAX draws at each step (`choice(fold_in(k_steps, s),
    bs, (k_pad,))`, its first k): the on-device cadence (g + 1) %
    (reassign_every + floor(min counts)) and its torch.where gate give the
    same steps, centres within 1e-5 and equal counts."""
    n, bs, epochs, k = 2000, 100, 3, 5
    x, _ = _blobs(n // k, k, 16, 0.6, seed=2)
    x[:, 0] += 5.0  # every row has cos > 0 with every other
    rng = np.random.default_rng(4)
    init = _normalize(x[rng.choice(n, k, replace=False)]).astype(np.float32)
    init[-1] = -np.eye(16, dtype=np.float32)[0]  # nearest to no row: starved
    perms = [rng.permutation(n) for _ in range(epochs)]

    steps, k_pad = -(-n // bs), jk.k_bucket_size(k, 8)
    key = jax.random.split(jax.random.PRNGKey(0), 3)[2]
    draws = []
    for _ in range(epochs):
        key, _, k_steps = jax.random.split(key, 3)
        draws.append(torch.from_numpy(np.stack([
            np.asarray(jax.random.choice(jax.random.fold_in(k_steps, s), bs, (k_pad,),
                                         replace=k_pad > bs))[:k]
            for s in range(steps)])))

    jax_perms = iter(perms)
    monkeypatch.setattr(jk, "_kmeanspp_init",
                        lambda sub, key, k_pad, k_valid: jnp.asarray(_pad(init, k_pad)))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, m: jnp.asarray(next(jax_perms)))
    port_perms, port_draws = iter([np.arange(n)] + perms), iter(draws)
    monkeypatch.setattr(tk, "_kmeanspp_init", lambda sub, u, kk: torch.from_numpy(init))
    monkeypatch.setattr(tk, "_permutation", lambda m, g: torch.from_numpy(next(port_perms)))
    monkeypatch.setattr(tk, "_reassignment_draws", lambda s, b, kk, g: next(port_draws))

    kwargs = dict(batch_size=bs, n_epochs=epochs, max_no_improvement=30)
    j = jk.MiniBatchSphericalKMeans(k, **kwargs).fit(x)
    t = tk.MiniBatchSphericalKMeans(k, **kwargs).fit(torch.from_numpy(x))
    assert t._counts.min() > 0  # the starved centre was moved onto a row
    assert t.n_steps_ == j.n_steps_
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t._counts, j._counts)


@pytest.mark.parametrize("step_offset", [0, 7, 30])
def test_fit_epoch_reassignment_cadence_matches_jax(step_offset):
    """One epoch from counts whose minimum is 3.7 on a centre nearest to no
    row, so the interval stays reassign_every + floor(3.7) = 13 until it
    fires at global step g with (g + 1) % 13 == 0; the port fed JAX's rows:
    every step's inertia, movement, centres and counts within 1e-5."""
    n, bs, k = 1000, 50, 5
    x, _ = _blobs(n // k, k, 16, 0.6, seed=3)
    x[:, 0] += 5.0
    rng = np.random.default_rng(8)
    centers = _normalize(x[rng.choice(n, k, replace=False)]).astype(np.float32)
    centers[2] = -np.eye(16, dtype=np.float32)[0]
    counts = np.array([40, 55, 3.7, 120, 2000], np.float32)
    perm = rng.permutation(n)
    steps = n // bs
    key = jax.random.PRNGKey(11)
    new_idx = np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, s), bs, (k,),
                                                     replace=k > bs)) for s in range(steps)])
    _, _, j_tr = jk._fit_epoch(jnp.asarray(x), jnp.asarray(perm), jnp.asarray(centers),
                               jnp.asarray(counts), key, jnp.int32(step_offset), 0.01,
                               jnp.int32(k), bs=bs, reassign_every=10)
    _, _, t_tr = tk._fit_epoch(torch.from_numpy(x), torch.from_numpy(perm),
                               torch.from_numpy(centers), torch.from_numpy(counts),
                               torch.from_numpy(new_idx), step_offset, 0.01,
                               bs=bs, reassign_every=10)
    fired = next(s for s in range(steps) if (step_offset + s + 1) % 13 == 0)
    t_counts = t_tr[3].numpy()
    assert (t_counts[:fired, 2] == 3.7).all() and t_counts[fired, 2] >= 40
    for j, t in zip(j_tr, t_tr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _spherical_inertia(x, centers):
    return float(np.sum(2 - 2 * (_normalize(x) @ centers.T).max(axis=1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_fit_quality_matches_jax(seed):
    # well-separated blobs: at noise 0.3-0.5 both packages' seeded fits
    # stop in a local minimum (a merged and a split blob) about one time in
    # four, each on other seeds, so a single pair would compare two draws
    # of that luck rather than the two implementations
    x, _ = _blobs(2000, 6, 32, 0.2, seed=seed)
    kwargs = dict(batch_size=1024, seed=seed)
    j = jk.MiniBatchSphericalKMeans(6, **kwargs).fit(x)
    t = tk.MiniBatchSphericalKMeans(6, **kwargs).fit(torch.from_numpy(x))
    j_inertia = _spherical_inertia(x, j.cluster_centers_)
    t_inertia = _spherical_inertia(x, t.cluster_centers_)
    assert abs(t_inertia - j_inertia) <= 0.02 * j_inertia
    ari = _adjusted_rand_index(t.predict(torch.from_numpy(x)).numpy(), np.asarray(j.predict(x)))
    assert ari >= 0.95


def test_seeded_fit_is_deterministic():
    x, _ = _blobs(500, 4, 8, 0.5)
    fits = [tk.MiniBatchSphericalKMeans(4, batch_size=256, seed=s).fit(torch.from_numpy(x))
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(fits[0].cluster_centers_, fits[1].cluster_centers_)
    assert fits[0].n_steps_ == fits[1].n_steps_
    assert not np.array_equal(fits[0].cluster_centers_, fits[2].cluster_centers_)
    np.testing.assert_allclose(np.linalg.norm(fits[0].cluster_centers_, axis=1), 1.0, atol=1e-5)


def test_kmeanspp_init_is_inverse_cdf_d2_sampling():
    """Against a float64 numpy loop with the same uniforms."""
    rng = np.random.default_rng(5)
    x = _normalize(rng.normal(size=(300, 6))).astype(np.float32)
    u = rng.random(7)
    got = tk._kmeanspp_init(torch.from_numpy(x), torch.from_numpy(u), 7).numpy()
    rows = [int(u[0] * len(x))]
    d2 = ((x - x[rows[0]]) ** 2).sum(1)
    for i in range(1, 7):
        cdf = np.cumsum(np.maximum(d2, 1e-12).astype(np.float64))
        rows.append(int(np.searchsorted(cdf, u[i] * cdf[-1])))
        d2 = np.minimum(d2, ((x - x[rows[-1]]) ** 2).sum(1))
    np.testing.assert_array_equal(got, x[rows])
    assert len(set(rows)) == 7  # a drawn row has d2 = 0 and is not drawn again


def test_init_centers_and_inertia_match_jax_definitions():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    np.testing.assert_allclose(tk._l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jk._l2_normalize(jnp.asarray(x))), atol=1e-7)
    xn, c = _normalize(x).astype(np.float32), _normalize(x[:4]).astype(np.float32)
    np.testing.assert_allclose(
        float(tk._spherical_inertia(torch.from_numpy(xn), torch.from_numpy(c))),
        float(jk._spherical_inertia(jnp.asarray(xn), jnp.asarray(c))), rtol=1e-5)
    np.testing.assert_allclose(tk.mean_spherical_inertia(torch.from_numpy(x), c),
                               _spherical_inertia(x, c) / len(x), rtol=1e-5)
    init = tk._init_centers(torch.from_numpy(x), torch.Generator().manual_seed(0), 4).numpy()
    rows = [int(np.argmin(np.abs(_normalize(x) - r).sum(1))) for r in init]
    assert len(set(rows)) == 4
    np.testing.assert_allclose(init, _normalize(x[rows]), atol=1e-6)


def test_partial_fit_then_predict_shapes_match_jax():
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(256, 8)).astype(np.float32)
    j = jk.MiniBatchSphericalKMeans(n_clusters=5).partial_fit(batch).partial_fit(batch)
    t = tk.MiniBatchSphericalKMeans(n_clusters=5)
    t.partial_fit(torch.from_numpy(batch)).partial_fit(torch.from_numpy(batch))
    assert t.cluster_centers_.shape == j.cluster_centers_.shape == (5, 8)
    assert t._counts.shape == j._counts.shape == (5,)
    assert t.n_steps_ == j.n_steps_ == 2
    assert t._counts.sum() == j._counts.sum() == 512
    assert tuple(t.predict(torch.from_numpy(batch)).shape) == np.asarray(j.predict(batch)).shape


def test_partial_fit_resumes_centres_without_counts():
    rng = np.random.default_rng(1)
    batch = rng.normal(size=(64, 4)).astype(np.float32)
    t = tk.MiniBatchSphericalKMeans(n_clusters=3)
    t.cluster_centers_ = _normalize(batch[:3])
    t.partial_fit(torch.from_numpy(batch))
    assert t._counts.sum() == 64 and t.n_steps_ == 1


@pytest.mark.parametrize("k", [0, -2])
def test_invalid_n_clusters_raises(k):
    with pytest.raises(ValueError):
        tk.MiniBatchSphericalKMeans(n_clusters=k)
    with pytest.raises(ValueError):
        jk.MiniBatchSphericalKMeans(n_clusters=k)


def test_predict_before_fit_raises():
    with pytest.raises(RuntimeError):
        tk.MiniBatchSphericalKMeans(n_clusters=2).predict(torch.zeros((3, 2)))


def test_partial_flat_unflat_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    flat, shape = partial_flat(torch.from_numpy(x))
    j_flat, j_shape = jax_partial_flat(jnp.asarray(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
    assert shape == tuple(j_shape)
    np.testing.assert_array_equal(partial_unflat(flat, shape).numpy(), x)
    np.testing.assert_array_equal(partial_unflat(flat, n=2, h=3, w=4).numpy(),
                                  np.asarray(jax_partial_unflat(j_flat, n=2, h=3, w=4)))
    with pytest.raises(ValueError):
        partial_unflat(torch.from_numpy(x))
