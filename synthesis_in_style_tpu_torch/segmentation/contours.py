"""Contour machinery of the host back half (counterpart of
synthesis_in_style_tpu/segmentation/contours.py, its pure path), on the
OpenCV-free primitives of utils/contour_ops.py.

Every function returns what the JAX module returns, contour for contour and
in the same order (tests/test_torch_host_contours.py):

* `merge_contours` is the same fixpoint: each round joins every group of
  transitively overlapping contours (connected components of the overlap
  graph, groups in order of their first member) and replaces the group by
  the external contours of its filled union; rounds repeat until no pair
  overlaps.
* Bounding boxes overlap only strictly: boxes that merely touch never merge.
* Overlaps are counted on filled rasters made for many contours at once
  (`contour_ops.filled_pixels`), and every union of a merge round, over all
  images of a batch, is traced in one call.
* The JAX module's thread pool is left out: the tracer holds the GIL, so
  the parallelism of this route is `contour_pool`'s worker processes.

Data shapes:
  ClassContours             = {class_name: [contours or None per image]}
  ClassContoursForSubImages = {sub_image_key: {class_name: [contours per image]}}
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from synthesis_in_style_tpu_torch.utils import contour_ops

Contour = np.ndarray
ClassContours = Dict[str, List[Optional[List[Contour]]]]
ClassContoursForSubImages = Dict[str, Dict[str, List[List[Contour]]]]


def dilate_image(image: np.ndarray, kernel: Optional[np.ndarray] = None,
                 kernel_size: int = 3) -> np.ndarray:
    """Dilation by a cross kernel (or the given one), border neutral."""
    if kernel is None:
        kernel = contour_ops.cross_kernel(kernel_size)
    return contour_ops.dilate(image, kernel)


def cluster_image_to_contours(cluster_arrays: np.ndarray) -> List[List[Contour]]:
    """Dilate each (H, W) mask of a (B, H, W) stack by the 3x3 cross, then
    take its external contours (CHAIN_APPROX_SIMPLE)."""
    dilated = dilate_image(np.asarray(cluster_arrays, dtype=np.uint8))
    return contour_ops.find_contours_batch(dilated, "simple")


def _bboxes_overlap(a, b):
    """Strict comparisons: boxes that merely touch at their extreme row or
    column do not overlap, so such contours are never merged. Boxes are
    (x_min, y_min, x_max, y_max), each a number or an array of them."""
    return (a[0] < b[2]) & (a[2] > b[0]) & (a[1] < b[3]) & (a[3] > b[1])


def contour_overlap(contour1: Contour, contour2: Contour) -> int:
    """Number of shared filled pixels, 0 if the boxes do not overlap."""
    b1, b2 = contour_ops.contour_bounds_many([contour1, contour2])
    if not _bboxes_overlap(b1, b2):
        return 0
    a, _ = _shared_pixels(*contour_ops.filled_pixels([contour1, contour2]))
    return len(a)


def _shared_pixels(ids: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                   plane: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(a, b) with a < b, once per pixel that contours a and b both fill
    (pixels of different `plane`s never meet)."""
    if len(ids) < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    x0, y0 = xs.min(), ys.min()
    width, height = int(xs.max() - x0) + 1, int(ys.max() - y0) + 1
    keys = (ys - y0) * width + (xs - x0)
    if plane is not None:
        keys = keys + plane * (width * height)
    # only pixels filled more than once can be shared: count them first
    if int(keys.max()) < 4 * len(ids) + (1 << 22):
        many = np.bincount(keys)[keys] > 1
        ids, keys = ids[many], keys[many]
    order = np.lexsort((ids, keys))
    keys, ids = keys[order], ids[order]
    firsts, seconds = [], []
    d = 1
    while d < len(keys):
        same = keys[d:] == keys[:-d]
        if not same.any():
            break
        firsts.append(ids[:-d][same])
        seconds.append(ids[d:][same])
        d += 1
    if not firsts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(firsts), np.concatenate(seconds)


def _overlap_groups(problems: Sequence[Sequence[Contour]]):
    """For each contour list: its groups of transitively overlapping
    contours (each sorted, in order of their first member; None if no pair
    overlaps) and its contours' filled pixels (ids, xs, ys). A pair overlaps
    where their filled rasters share a pixel and their boxes overlap
    strictly; the groups are the connected components of that graph, as the
    JAX module's pairwise union-find finds them. All lists are rasterized
    and joined together."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    sizes = np.array([len(p) for p in problems], np.int64)
    offsets = np.cumsum(sizes) - sizes
    flat = [c for p in problems for c in p]
    n = len(flat)
    ids, xs, ys = contour_ops.filled_pixels(flat)
    problem = np.repeat(np.arange(len(problems)), sizes)
    a, b = _shared_pixels(ids, xs, ys, problem[ids])  # never across lists
    bounds = contour_ops.contour_bounds_many(flat)
    keep = _bboxes_overlap(bounds[a].T, bounds[b].T)
    a, b = a[keep], b[keep]
    graph = coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    order = np.argsort(labels, kind="stable")  # members ascending within a label
    members = np.split(order, np.cumsum(np.bincount(labels))[:-1])
    id_bounds = np.searchsorted(ids, np.append(offsets, n))  # ids come grouped
    joined = np.zeros(len(problems), bool)
    joined[problem[a]] = True
    out = []
    for k, (start, size) in enumerate(zip(offsets.tolist(), sizes.tolist())):
        sel = slice(id_bounds[k], id_bounds[k + 1])
        pixels = (ids[sel] - start, xs[sel], ys[sel])
        if not joined[k]:
            out.append((None, pixels))
            continue
        seen, groups = set(), []
        for i in range(start, start + size):  # groups in order of their first member
            if labels[i] not in seen:
                seen.add(labels[i])
                groups.append((members[labels[i]] - start).tolist())
        out.append((groups, pixels))
    return out


def _merge_contour_groups(groups: Sequence[Sequence[Contour]],
                          group_pixels: Sequence[Tuple[np.ndarray, np.ndarray]]
                          ) -> List[List[Contour]]:
    """For each group, the external contours (CHAIN_APPROX_NONE) of the
    union of its filled contours (`group_pixels`: their xs, ys). The unions
    are traced in one call: side by side on one canvas, one empty column
    apart, so each keeps its own outside; a union's contours keep their
    order (raster order within one union is its order on the shared
    canvas)."""
    boxes = []
    for group in groups:
        bounds = contour_ops.contour_bounds_many(group)
        boxes.append((int(bounds[:, 0].min()), int(bounds[:, 1].min()),
                      int(bounds[:, 2].max()), int(bounds[:, 3].max())))
    height = max(y1 - y0 + 1 for _, y0, _, y1 in boxes)
    lefts = np.cumsum([0] + [x1 - x0 + 2 for x0, _, x1, _ in boxes])
    shared = np.zeros((height, int(lefts[-1])), bool)
    for (xs, ys), (x0, y0, _, _), left in zip(group_pixels, boxes, lefts):
        shared[ys - y0, xs - x0 + left] = True
    out: List[List[Contour]] = [[] for _ in groups]
    for contour in contour_ops.find_contours(shared, "none"):
        k = int(np.searchsorted(lefts, contour[0, 0, 0], side="right")) - 1
        x0, y0 = boxes[k][:2]
        out[k].append(contour + np.array([x0 - lefts[k], y0], np.int32))
    return out


def merge_two_contours_if_overlapping(contour1: Contour, contour2: Contour
                                      ) -> Optional[List[Contour]]:
    """External contours of the union, or None if the pair does not
    overlap."""
    if contour_overlap(contour1, contour2) == 0:
        return None
    _, xs, ys = contour_ops.filled_pixels([contour1, contour2])
    return _merge_contour_groups([[contour1, contour2]], [(xs, ys)])[0]


def merge_contours_many(problems: Sequence[List[Contour]], only_keep_overlapping: bool = False
                        ) -> List[List[Contour]]:
    """`merge_contours` of each contour list, the rounds of all lists run in
    step so that each round's unions are traced in one call."""
    states = [[(frozenset([i]), c) for i, c in enumerate(contours)] for contours in problems]
    active = [k for k, items in enumerate(states) if len(items) > 1]
    while active:
        plans = {}
        jobs: List[List[Contour]] = []
        job_pixels: List[Tuple[np.ndarray, np.ndarray]] = []
        found = _overlap_groups([[c for _, c in states[k]] for k in active])
        for k, (groups, (ids, xs, ys)) in zip(active, found):
            items = states[k]
            if groups is None:
                continue
            plan = []
            for members in groups:
                if len(members) == 1:
                    plan.append(items[members[0]])
                    continue
                plan.append((frozenset().union(*(items[m][0] for m in members)), len(jobs)))
                jobs.append([items[m][1] for m in members])
                mine = np.concatenate([np.arange(lo, hi) for lo, hi in zip(
                    np.searchsorted(ids, members), np.searchsorted(ids, members, "right"))])
                job_pixels.append((xs[mine], ys[mine]))
            plans[k] = plan
        merged = _merge_contour_groups(jobs, job_pixels) if jobs else []
        for k, plan in plans.items():
            new_items = []
            for ids_, entry in plan:
                if isinstance(entry, int):
                    new_items.extend((ids_, c) for c in merged[entry])
                else:
                    new_items.append((ids_, entry))
            states[k] = new_items
        active = [k for k in plans if len(states[k]) > 1]
    if only_keep_overlapping:
        return [[c for ids, c in items if len(ids) > 1] for items in states]
    return [[c for _, c in items] for items in states]


def merge_contours(contours: List[Contour], only_keep_overlapping: bool = False
                   ) -> List[Contour]:
    """Fixpoint merge of all transitively overlapping contours. With
    `only_keep_overlapping`, only contours that absorbed at least two
    originals are returned."""
    return merge_contours_many([contours], only_keep_overlapping)[0]


def merge_contours_of_same_class_from_different_images(
    class_contours_for_sub_images: ClassContoursForSubImages,
    batch_size: int,
    only_keep_overlapping: bool = False,
    class_names_to_merge: Tuple[str, ...] = (),
    drop_if_size_of_contours_zero: bool = False,
) -> ClassContours:
    """Cross-sub-image merge, per class and image: all empty -> None; with
    `drop_if_size_of_contours_zero`, any empty -> None; one non-empty source
    -> its contours as they are; otherwise the fixpoint merge of the
    flattened list."""
    if len(class_names_to_merge) == 0:
        class_names_to_merge = tuple({
            class_name
            for sub_image_data in class_contours_for_sub_images.values()
            for class_name in sub_image_data.keys()
        })

    class_to_contours: Dict[str, List[List[List[Contour]]]] = defaultdict(list)
    for class_contours in class_contours_for_sub_images.values():
        for class_name, contours in class_contours.items():
            class_to_contours[class_name].append(contours)

    result: ClassContours = defaultdict(list)
    pending = []  # (class, image, flat contours) of the merges, run together
    for class_name, contours_for_class in class_to_contours.items():
        for batch_id in range(batch_size):
            per_sub_image = [c[batch_id] for c in contours_for_class]
            empties = [len(c) == 0 for c in per_sub_image]
            if all(empties):
                out = None
            elif (drop_if_size_of_contours_zero and class_name in class_names_to_merge
                  and any(empties)):
                out = None
            elif any(empties):
                out = next(sub for sub, empty in zip(per_sub_image, empties) if not empty)
            else:
                out = [c for sub in per_sub_image for c in sub]
                if class_name in class_names_to_merge and len(per_sub_image) > 1:
                    pending.append((class_name, batch_id, out))
            result[class_name].append(out)
    merged = merge_contours_many([flat for _, _, flat in pending], only_keep_overlapping)
    for (class_name, batch_id, _), contours in zip(pending, merged):
        result[class_name][batch_id] = contours or None
    return result


def merge_contours_of_same_class_from_same_image(class_contours: ClassContours
                                                 ) -> ClassContours:
    """Per-image fixpoint merge."""
    merged_all: ClassContours = {}
    for class_name, batch_contours in class_contours.items():
        merged = iter(merge_contours_many([c for c in batch_contours if c is not None]))
        merged_all[class_name] = [None if c is None else next(merged) for c in batch_contours]
    return merged_all


def drop_too_small_contours(class_contours: ClassContours, min_area: float) -> ClassContours:
    """Keep contours whose polygon area is >= min_area; empties become None."""
    adjusted: ClassContours = {}
    for class_name, batch_contours in class_contours.items():
        adjusted_batch = []
        for contours in batch_contours:
            if contours is not None:
                areas = contour_ops.contour_areas(contours)
                contours = [c for c, area in zip(contours, areas) if area >= min_area]
                if len(contours) == 0:
                    contours = None
            adjusted_batch.append(contours)
        adjusted[class_name] = adjusted_batch
    return adjusted


def classify_fine_grained_contours(
    text_regions_per_class: ClassContours,
    fine_grained_contours_per_class: ClassContours,
    class_id_map: Dict[str, int],
    fine_grained_class_name: str = "printed_text",
) -> ClassContours:
    """Assign each fine-grained contour to the class whose text regions it
    overlaps most (shared filled pixels, counted for regions whose box
    overlaps the contour's strictly); ties go to the first class in
    class-id order, and a contour that overlaps none is dropped."""
    assert len(text_regions_per_class) == len(fine_grained_contours_per_class), (
        "Num classes of text regions and fine grained contours must be equal!"
    )
    fine_batches = fine_grained_contours_per_class[fine_grained_class_name]
    text_regions_per_class = dict(
        sorted(text_regions_per_class.items(), key=lambda x: class_id_map[x[0]]))
    batch_size = len(fine_batches)
    classified: ClassContours = {class_name: [[] for _ in range(batch_size)]
                                 for class_name in text_regions_per_class}
    for batch_id, fine_contours in enumerate(fine_batches):
        scored = []  # (class, overlap per fine contour), in class-id order
        if fine_contours is not None and len(fine_contours) > 0:
            n = len(fine_contours)
            for class_name, text_regions_batch in text_regions_per_class.items():
                regions = text_regions_batch[batch_id]
                if regions is None:
                    continue
                both = list(fine_contours) + list(regions)
                a, b = _shared_pixels(*contour_ops.filled_pixels(both))
                cross = (a < n) & (b >= n)
                a, b = a[cross], b[cross]
                bounds = contour_ops.contour_bounds_many(both)
                a = a[_bboxes_overlap(bounds[a].T, bounds[b].T)]
                scored.append((class_name, np.bincount(a, minlength=n)))
        if scored:
            counts = np.stack([c for _, c in scored], axis=1)
            best = counts.argmax(axis=1)  # the first maximum: the lowest class id
            for contour_id in np.flatnonzero(counts.max(axis=1) > 0).tolist():
                classified[scored[best[contour_id]][0]][batch_id].append(
                    fine_contours[contour_id])
        for class_name in text_regions_per_class:
            if len(classified[class_name][batch_id]) == 0:
                classified[class_name][batch_id] = None
    return classified


def render_segmentation_image(
    fine_grained_prediction: Dict[str, np.ndarray],
    classified_contours: ClassContours,
    batch_size: int,
    image_size: int,
    class_to_color_map: Dict[str, Tuple[int, int, int]],
    cluster_class_name: str = "printed_text",
    class_clip_masks: Optional[Dict[str, np.ndarray]] = None,
) -> np.ndarray:
    """Paint (filled contour AND fine cluster mask [AND the class's clip
    mask]) per class and contour onto a background canvas; later paint
    wins. Returns (B, H, W, 3) uint8."""
    fine_masks = {name: np.asarray(mask) for name, mask in fine_grained_prediction.items()}
    fine = fine_masks[cluster_class_name].astype(bool)
    colors = np.array([class_to_color_map[name] for name in fine_masks], np.uint8)
    canvas = np.zeros((batch_size, image_size, image_size, 3), np.uint8)
    canvas[:] = class_to_color_map["background"]
    for batch_id in range(batch_size):
        contours, class_of = [], []  # in paint order
        for k, class_name in enumerate(fine_masks):
            batch_contours = classified_contours.get(class_name)
            if class_name == "background" or not batch_contours \
                    or batch_contours[batch_id] is None:
                continue
            contours.extend(batch_contours[batch_id])
            class_of.extend([k] * len(batch_contours[batch_id]))
        if not contours:
            continue
        ids, xs, ys = contour_ops.filled_pixels(contours)
        inside = (xs >= 0) & (xs < image_size) & (ys >= 0) & (ys < image_size)
        ids, xs, ys = ids[inside], xs[inside], ys[inside]
        cls = np.asarray(class_of)[ids]
        paint = fine[batch_id][ys, xs]
        if class_clip_masks is not None:
            names = list(fine_masks)
            for k in np.unique(cls).tolist():
                sel = cls == k
                paint[sel] &= np.asarray(class_clip_masks[names[k]][batch_id])[ys[sel], xs[sel]]
        ids, xs, ys, cls = ids[paint], xs[paint], ys[paint], cls[paint]
        # the last contour in paint order wins each pixel
        order = np.lexsort((ids, ys * image_size + xs))
        key = (ys * image_size + xs)[order]
        last = np.ones(len(order), bool)
        last[:-1] = key[1:] != key[:-1]
        pick = order[last]
        canvas[batch_id, ys[pick], xs[pick]] = colors[cls[pick]]
    return canvas
