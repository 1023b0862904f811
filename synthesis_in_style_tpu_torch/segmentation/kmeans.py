"""Minibatch spherical k-means in PyTorch (counterpart of
synthesis_in_style_tpu/segmentation/kmeans.py, the sklearn-0.24
MiniBatchKMeans semantics the reference inherits).

Data and centres are L2-normalized at every step, points are assigned by
cosine similarity (one (B, D) @ (D, K) product), centres move by an
incremental per-centre mean and are renormalized, starved centres are
periodically moved onto random batch samples, and the fit stops when the
exponentially weighted batch inertia makes no improvement for
`max_no_improvement` consecutive batches.

Device rules:

* An epoch runs without a host sync: the reassignment decision is a device
  tensor taken through `torch.where` over both branches, and the per-step
  inertia, squared centre movement, centres and counts stay on the device
  until the epoch ends. The host then fetches the two scalar traces once
  and applies the stopping rule step by step, as the JAX package does with
  its scan's traces.
* Every random draw comes from a `torch.Generator` on the CPU seeded by
  `seed`, taken once per epoch (the permutation, the reassignment indices)
  or once per initialisation trial (the k-means++ uniforms), and moved to
  the device. A fit on the card and the same fit on the CPU see the same
  draws. JAX's random streams cannot be reproduced, so a fit here does not
  match the JAX package's bit for bit; the deterministic parts do.

Centres are fitted unpadded: the JAX package pads them to a bucket of k
only to share XLA compiles, and its deterministic trajectories do not
depend on the bucket.

`assign_euclidean` is the prediction rule of the catalogs (plain
euclidean argmin against the stored centres, the queries not normalized).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def _permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A random permutation of range(n), drawn on the CPU."""
    return torch.randperm(n, generator=generator)


def _reassignment_draws(steps: int, batch: int, k: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(steps, k) batch row indices for the starved-centre moves of each
    step, drawn on the CPU: distinct within a step when k <= batch (the
    JAX package draws `choice(batch, (k,), replace=k > batch)`)."""
    if k > batch:
        return torch.randint(batch, (steps, k), generator=generator)
    return torch.stack([torch.randperm(batch, generator=generator)[:k] for _ in range(steps)])


def _init_centers(x: torch.Tensor, generator: torch.Generator, k: int) -> torch.Tensor:
    """k distinct rows of x, normalized (the partial_fit initialisation)."""
    idx = _permutation(x.shape[0], generator)[:k].to(x.device)
    return _l2_normalize(x[idx])


def _kmeanspp_init(x: torch.Tensor, u: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ D^2-sampling on (already normalized) samples x (m, D),
    driven by k uniforms `u` in [0, 1) on x's device: the first centre is
    row floor(u[0] * m); centre i is drawn by inverse CDF with probability
    proportional to max(d2, 1e-12), d2 the squared distance to the nearest
    centre so far (the JAX package samples the same law by
    `jax.random.categorical`). No host sync."""
    m = x.shape[0]
    first = x[(u[:1] * m).long().clamp_max(m - 1)]  # (1, D)
    centers = [first]
    d2 = ((x - first) ** 2).sum(dim=1)
    for i in range(1, k):
        cdf = torch.cumsum(d2.clamp_min(1e-12).double(), dim=0)
        idx = torch.searchsorted(cdf, u[i:i + 1] * cdf[-1:]).clamp_max(m - 1)
        c = x[idx]
        centers.append(c)
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=1))
    return torch.cat(centers, dim=0)


def _spherical_inertia(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """sum over rows of 2 - 2 max_k cos(x, c_k), for normalized x."""
    return (2.0 - 2.0 * (x @ centers.t()).max(dim=1).values).sum()


def _reassign_starved(
    centers: torch.Tensor,  # (K, D)
    counts: torch.Tensor,  # (K,)
    xb: torch.Tensor,  # (B, D) normalized batch
    new_idx: torch.Tensor,  # (K,) batch rows, drawn by the caller
    reassignment_ratio: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move the centres whose count is < ratio * max(count) onto the batch
    rows `new_idx`, at most B // 2 of them, the lowest counts first (ties by
    index: both argsorts are stable, as jnp.argsort is); their counts reset
    to the minimum count of the centres that stay (0 if none stays)."""
    to_reassign = counts < reassignment_ratio * counts.max()
    cap = xb.shape[0] // 2
    rank = torch.argsort(torch.argsort(counts, stable=True), stable=True)
    to_reassign = to_reassign & (rank < cap)
    centers = torch.where(to_reassign[:, None], xb[new_idx], centers)
    surviving_min = torch.where(to_reassign, float("inf"), counts).min()
    surviving_min = torch.where(torch.isfinite(surviving_min), surviving_min, 0.0)
    counts = torch.where(to_reassign, surviving_min, counts)
    return centers, counts


def _minibatch_step(
    centers: torch.Tensor,  # (K, D), unit norm
    counts: torch.Tensor,  # (K,)
    batch: torch.Tensor,  # (B, D)
    do_reassign,  # bool, or a () bool tensor on the device
    new_idx: Optional[torch.Tensor],  # (K,) reassignment rows; unused when never reassigning
    reassignment_ratio: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step: assign -> (reassign starved) -> incremental per-centre mean
    -> renormalize; a centre with no point in the batch stays where it is.
    Returns (centers, counts, batch_inertia, squared_center_diff)."""
    xb = _l2_normalize(batch)
    best, assign = (xb @ centers.t()).max(dim=1)  # ties: the first index
    # inertia on normalized vectors: ||x - c||^2 = 2 - 2 cos
    inertia = (2.0 - 2.0 * best).sum()

    if do_reassign is not False:
        re_centers, re_counts = _reassign_starved(centers, counts, xb, new_idx,
                                                  reassignment_ratio)
        do_reassign = torch.as_tensor(do_reassign, device=xb.device)
        centers = torch.where(do_reassign, re_centers, centers)
        counts = torch.where(do_reassign, re_counts, counts)
    old_centers = centers

    # one-hot sums (F.one_hot and bincount would sync to check their range)
    onehot = (assign[:, None] == torch.arange(centers.shape[0], device=xb.device)).to(xb.dtype)
    batch_counts = onehot.sum(dim=0)
    batch_sums = onehot.t() @ xb
    new_counts = counts + batch_counts
    safe_counts = new_counts.clamp_min(1.0)
    updated = centers + (batch_sums - batch_counts[:, None] * centers) / safe_counts[:, None]
    centers = torch.where(batch_counts[:, None] > 0, _l2_normalize(updated), centers)
    squared_diff = ((centers - old_centers) ** 2).sum()
    return centers, new_counts, inertia, squared_diff


def _fit_epoch(
    x: torch.Tensor,  # (N, D)
    perm: torch.Tensor,  # (steps * bs,) row indices, on x's device
    centers: torch.Tensor,
    counts: torch.Tensor,
    new_idx: Optional[torch.Tensor],  # (steps, K) reassignment rows, on x's device
    step_offset: int,  # global step of the epoch's first batch
    reassignment_ratio: float,
    *,
    bs: int,
    reassign_every: int,
):
    """One epoch of minibatch steps with no host sync. Returns (centers,
    counts, (inertias, squared_diffs, centers, counts)) with one entry per
    step stacked in each trace, all on the device."""
    steps = perm.shape[0] // bs
    g_next = torch.arange(step_offset + 1, step_offset + steps + 1, device=x.device)
    traces: Tuple[List[torch.Tensor], ...] = ([], [], [], [])
    for s in range(steps):
        batch = x[perm[s * bs:(s + 1) * bs]]
        if reassignment_ratio > 0:
            # sklearn-0.24 cadence: (iter + 1) % (base + int(min(counts))) == 0,
            # an interval that grows as the counts accumulate
            interval = reassign_every + counts.min().floor().long()
            do_reassign = g_next[s] % interval == 0
            idx = new_idx[s]
        else:
            do_reassign, idx = False, None
        centers, counts, inertia, sq_diff = _minibatch_step(
            centers, counts, batch, do_reassign, idx, reassignment_ratio)
        for trace, value in zip(traces, (inertia, sq_diff, centers, counts)):
            trace.append(value)
    return centers, counts, tuple(torch.stack(t) for t in traces)


def assign_euclidean(
    x: torch.Tensor, centers: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 for x (N, C), centers (K, C), as one product:
    ||x||^2 is constant per row, so score = -2 x.c + ||c||^2. With `valid`
    (K,) bool, invalid centres never win. Ties go to the lowest index."""
    centers = centers.to(device=x.device, dtype=x.dtype)
    scores = -2.0 * (x @ centers.t()) + (centers * centers).sum(dim=1)[None, :]
    if valid is not None:
        scores = torch.where(valid[None, :], scores, torch.full_like(scores, float("inf")))
    return torch.argmin(scores, dim=1)


def mean_spherical_inertia(x: torch.Tensor, centers: torch.Tensor) -> float:
    """Mean over the rows of raw x (N, D) of 2 - 2 max_k cos(x, c_k)
    against unit-norm centres, without a normalized copy of x."""
    centers = torch.as_tensor(centers, device=x.device, dtype=x.dtype)
    inv_norm = torch.rsqrt((x * x).sum(dim=1) + 1e-12)
    best = (x @ centers.t()).max(dim=1).values * inv_norm
    return float((2.0 - 2.0 * best).mean())


class MiniBatchSphericalKMeans:
    """Minibatch spherical k-means estimator (the JAX package's class and
    defaults).

    `n_epochs` is a cap: `fit` stops early when the exponentially weighted
    batch inertia stops improving for `max_no_improvement` consecutive
    batches or (with `tol` > 0) when the weighted per-batch centre movement
    falls below tol * the mean feature variance of the normalized data
    (sklearn 0.24's rule; iteration 0 is ignored). `reassign_every` is the
    base of the growing reassignment interval `base + int(min(counts))`.
    `k_bucket` is kept for the JAX signature and has no effect: centres are
    fitted unpadded. The fit runs on the device of the data it is given.
    """

    def __init__(
        self,
        n_clusters: int,
        batch_size: int = 16384,
        n_epochs: int = 3,
        seed: int = 0,
        reassignment_ratio: float = 0.01,
        reassign_every: int = 10,
        max_no_improvement: int = 10,
        tol: float = 0.0,
        n_init: int = 3,
        k_bucket: int = 8,
    ):
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        self.n_clusters = n_clusters
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.seed = seed
        self.n_init = n_init
        self.reassignment_ratio = reassignment_ratio
        self.reassign_every = reassign_every
        self.max_no_improvement = max_no_improvement
        self.tol = tol
        self.k_bucket = k_bucket
        self.cluster_centers_: Optional[np.ndarray] = None
        self._counts: Optional[np.ndarray] = None
        self.n_steps_: int = 0

    def fit(self, x) -> "MiniBatchSphericalKMeans":
        x = torch.as_tensor(x)
        device = x.device
        n = x.shape[0]
        k = self.n_clusters
        generator = torch.Generator().manual_seed(self.seed)
        bs = min(self.batch_size, n)

        # k-means++ on a 3 * batch_size subsample, best of n_init candidates
        # by spherical inertia on that subsample
        init_size = min(3 * bs, n)
        sub = _l2_normalize(x[_permutation(n, generator)[:init_size].to(device)])
        centers, best_inertia = None, None
        for _ in range(max(1, self.n_init)):
            u = torch.rand(k, generator=generator, dtype=torch.float64).to(device)
            cand = _l2_normalize(_kmeanspp_init(sub, u, k))
            cand_inertia = float(_spherical_inertia(sub, cand))
            if best_inertia is None or cand_inertia < best_inertia:
                centers, best_inertia = cand, cand_inertia
        del sub
        counts = torch.zeros(k, device=device, dtype=centers.dtype)
        # ceil, so that no sample of the permutation is dropped: the last
        # batch wraps to the head of the same permutation
        steps_per_epoch = -(-n // bs)

        # sklearn 0.24's stopping rule, applied per batch on the host from
        # each epoch's traces
        alpha = min(float(bs) * 2.0 / (n + 1), 1.0)
        tol_scaled = 0.0
        if self.tol > 0:
            tol_scaled = float(_l2_normalize(x).var(dim=0, unbiased=False).mean()) * self.tol
        ewa_inertia: Optional[float] = None
        ewa_diff: Optional[float] = None
        ewa_min: Optional[float] = None
        no_improvement = 0
        global_step = 0

        for _ in range(self.n_epochs):
            perm = _permutation(n, generator)
            perm = torch.cat([perm, perm[: steps_per_epoch * bs - n]]).to(device)
            new_idx = None
            if self.reassignment_ratio > 0:
                new_idx = _reassignment_draws(steps_per_epoch, bs, k, generator).to(device)
            centers, counts, traces = _fit_epoch(
                x, perm, centers, counts, new_idx, global_step, self.reassignment_ratio,
                bs=bs, reassign_every=self.reassign_every,
            )
            scalars = torch.stack(traces[:2]).cpu().numpy()  # the epoch's one fetch
            centers_tr, counts_tr = traces[2], traces[3]
            for s in range(steps_per_epoch):
                is_first = global_step == 0
                global_step += 1
                if is_first:
                    continue  # sklearn ignores iteration 0
                batch_inertia = float(scalars[0, s]) / bs
                batch_diff = float(scalars[1, s]) / bs
                if ewa_inertia is None:
                    ewa_inertia, ewa_diff = batch_inertia, batch_diff
                else:
                    ewa_inertia = ewa_inertia * (1 - alpha) + batch_inertia * alpha
                    ewa_diff = ewa_diff * (1 - alpha) + batch_diff * alpha
                if self.tol > 0 and ewa_diff <= tol_scaled:
                    self._finish(centers_tr[s], counts_tr[s], global_step)
                    return self
                if ewa_min is None or ewa_inertia < ewa_min:
                    ewa_min = ewa_inertia
                    no_improvement = 0
                else:
                    no_improvement += 1
                if (self.max_no_improvement is not None
                        and no_improvement >= self.max_no_improvement):
                    self._finish(centers_tr[s], counts_tr[s], global_step)
                    return self
        self._finish(centers, counts, global_step)
        return self

    def _finish(self, centers: torch.Tensor, counts: torch.Tensor, n_steps: int) -> None:
        self.cluster_centers_ = centers.cpu().numpy()
        self._counts = counts.cpu().numpy()
        self.n_steps_ = n_steps

    def partial_fit(self, batch) -> "MiniBatchSphericalKMeans":
        """One minibatch step on `batch` (N, D). Reassignment fires with
        probability 1 / (reassign_every * (1 + int(min(counts)))), drawn
        from numpy's RandomState(seed + step) as in the JAX package."""
        batch = torch.as_tensor(batch)
        k = self.n_clusters
        if self.cluster_centers_ is None:
            generator = torch.Generator().manual_seed(self.seed)
            self.cluster_centers_ = _init_centers(batch, generator, k).cpu().numpy()
            self._counts = np.zeros((k,), np.float32)
        if self._counts is None:
            # centres restored without counts (legacy catalogs): resume with
            # zero counts, i.e. the full learning rate on the next batch
            self._counts = np.zeros((k,), np.float32)
        self.n_steps_ += 1
        rs = np.random.RandomState(self.seed + self.n_steps_)
        do_reassign = bool(
            self.reassignment_ratio > 0
            and rs.randint(self.reassign_every * (1 + int(self._counts.min()))) == 0
        )
        new_idx = None
        if do_reassign:
            generator = torch.Generator().manual_seed(self.seed + self.n_steps_)
            new_idx = _reassignment_draws(1, batch.shape[0], k, generator)[0].to(batch.device)
        centers, counts, _, _ = _minibatch_step(
            torch.as_tensor(self.cluster_centers_, device=batch.device, dtype=batch.dtype),
            torch.as_tensor(self._counts, device=batch.device, dtype=batch.dtype),
            batch, do_reassign, new_idx, self.reassignment_ratio,
        )
        self.cluster_centers_ = centers.cpu().numpy()
        self._counts = counts.cpu().numpy()
        return self

    def predict(self, x) -> torch.Tensor:
        """(N, D) -> (N,) nearest stored centre (euclidean, x as given), on
        x's device."""
        if self.cluster_centers_ is None:
            raise RuntimeError("fit first")
        x = torch.as_tensor(x)
        return assign_euclidean(x, torch.as_tensor(self.cluster_centers_))
