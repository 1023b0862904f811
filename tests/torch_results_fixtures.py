"""A seeded sweep `results.json` as `cli/analyze_image_segments.py` writes
it: 12 runs (min_confidence 0.0 / 0.5 / 0.7 x min_contour_area 0 / 55 x
patch_overlap (0, 0.0) / (0, 0.5)) over 4 pages, three classes, four
metrics, from seeded per-page confusion matrices. No JAX import."""

import numpy as np

from synthesis_in_style_tpu_torch.evaluation.metrics import calculate_metric

CLASSES = ("background", "printed_text", "handwritten_text")
PAGES = ("page_a", "page_b", "page_c", "page_d")
METRICS = ("dice", "iou", "precision", "recall")


def make_results(seed: int = 0) -> dict:
    """Runs as `cli/analyze_image_segments.py` writes them, from seeded
    per-page confusion matrices."""
    rs = np.random.RandomState(seed)
    runs = []
    for conf in (0.0, 0.5, 0.7):
        for area in (0, 55):
            for overlap in (0.0, 0.5):
                run = {"confusion_matrices": {}}
                total = np.zeros((3, 3))
                for page in PAGES:
                    cm = rs.randint(0, 400, (3, 3)).astype(np.float64)
                    cm[np.diag_indices(3)] += rs.randint(500, 3000, 3)
                    run["confusion_matrices"][page] = [float(v) for v in cm.reshape(-1)]
                    for metric in METRICS:
                        run.setdefault(f"detailed_{metric}_scores", {})[page] = \
                            calculate_metric(cm, list(CLASSES), metric)
                    total += cm
                for metric in METRICS:
                    run[f"average_{metric}_scores"] = calculate_metric(total, list(CLASSES),
                                                                      metric)
                run["hyperparams"] = {"min_confidence": conf, "min_contour_area": area,
                                      "patch_overlap": [0, overlap]}
                runs.append(run)
    return {"general_config": {"experiment_config": {}, "model_config": {"network": "DocUFCN"},
                               "class_to_color_map": {}},
            "runs": runs}
