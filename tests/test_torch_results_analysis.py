"""The port's results tools against the JAX package's on the CPU, on a
seeded `results.json` of 12 sweep runs (min_confidence x min_contour_area x
patch_overlap) over 4 pages and three classes, laid out as the analyze CLI
writes it:

* every function of `evaluation/results_analysis.py` against the JAX
  module's (tables compared by their records against the DataFrames);
* `evaluate_metrics -p -c` and `-r`: the printed tables' numbers, in order,
  within 1e-5 relative (pandas prints some floats to 6 digits);
* `extract_results_subset`: the subset JSON equal to the JAX CLI's;
* `plot_metrics`: PNGs under the JAX CLI's file names;
* `COCODataset` over a `coco_gt.json` written by the port's
  `evaluation/coco_gt.py`: items and collation equal to the JAX dataset's.

pandas and matplotlib are imported here, for the JAX tools only."""

import copy
import json
import re

import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.cli import evaluate_metrics as jax_em
from synthesis_in_style_tpu.cli import extract_results_subset as jax_subset
from synthesis_in_style_tpu.cli import plot_metrics as jax_plot
from synthesis_in_style_tpu.data.coco_dataset import COCODataset as JaxCOCODataset
from synthesis_in_style_tpu.evaluation import results_analysis as jra
from synthesis_in_style_tpu_torch.cli import evaluate_metrics as em
from synthesis_in_style_tpu_torch.cli import extract_results_subset as subset_cli
from synthesis_in_style_tpu_torch.cli import plot_metrics as plot_cli
from synthesis_in_style_tpu_torch.data.coco_dataset import COCODataset
from synthesis_in_style_tpu_torch.evaluation import results_analysis as ra
from synthesis_in_style_tpu_torch.evaluation.coco_gt import create_coco_gt_from_image_root
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_results_fixtures import PAGES, make_results

def _records(df):
    return [{k: (v.item() if hasattr(v, "item") else v) for k, v in row.items()}
            for row in df.to_dict("records")]


def _assert_table(table: ra.Table, df) -> None:
    assert table.columns == list(df.columns)
    got, want = table.records(), _records(df)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-15), k
            else:
                assert g[k] == w[k], k


def _both(fn_name, results, *args):
    """The same function of both modules on copies of `results`."""
    ours, theirs = copy.deepcopy(results), copy.deepcopy(results)
    return (getattr(ra, fn_name)(ours, *args), ours), (getattr(jra, fn_name)(theirs, *args),
                                                       theirs)


def test_every_results_analysis_function_matches_jax():
    results = make_results()
    assert ra.get_calculated_score_key_filters(results) == \
        jra.get_calculated_score_key_filters(results)
    assert ra.get_calculated_score_key_filters(results, "detailed") == \
        jra.get_calculated_score_key_filters(results, "detailed")
    assert ra.extract_score_name("average_iou_scores") == \
        jra.extract_score_name("average_iou_scores") == "iou"
    scores = results["runs"][3]["average_iou_scores"]
    assert ra.calculate_mean_iou(scores) == jra.calculate_mean_iou(scores)
    (_, ours), (_, theirs) = _both("add_mean_iou", results)
    assert ours == theirs
    (_, ours), (_, theirs) = _both("preprocess_results", results)
    assert ours == theirs and ours["runs"][1]["hyperparams"]["patch_overlap"] == 0.5
    results = ours
    values = ["0.7", "0.0", "0.5", "0.0", "0.7"]
    assert ra.group_results_by_hyperparam_values(values, [1, 2, 3, 4, 5]) == \
        jra.group_results_by_hyperparam_values(values, [1, 2, 3, 4, 5])

    for key in ra.get_calculated_score_key_filters(results):
        ours, theirs = ra.get_tabular_results(results, key), jra.get_tabular_results(results, key)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1:] == theirs[1:]
        _assert_table(ra.get_best_results(results, key), jra.get_best_results(results, key))
        name = ra.extract_score_name(key)
        ours_m = ra.get_best_median_configs(*ours, name)
        theirs_m = jra.get_best_median_configs(*theirs, name)
        assert list(ours_m) == list(theirs_m)
        for hp in ours_m:
            _assert_table(ours_m[hp], theirs_m[hp])

    config = ["min_confidence", "0.7", "min_contour_area", "55"]
    ours, theirs = (ra.get_result_for_given_config(config, results),
                    jra.get_result_for_given_config(config, results))
    assert ours == theirs and len(ours) == 2
    _assert_table(ra.get_dataframe_from_results(ours), jra.get_dataframe_from_results(theirs))
    run = results["runs"][0]["hyperparams"]
    assert ra.are_configs_matching({"min_contour_area": "0"}, run) == \
        jra.are_configs_matching({"min_contour_area": "0"}, run) is True

    (_, ours), (_, theirs) = _both("remove_not_in_subset", results, ["page_b", "page_d"])
    assert ours == theirs and set(ours["runs"][0]["confusion_matrices"]) == {"page_b", "page_d"}
    np.testing.assert_array_equal(ra.compute_confusion_matrix(ours["runs"][2], 3),
                                  jra.compute_confusion_matrix(theirs["runs"][2], 3))
    ra.recompute_metrics(ours)
    jra.recompute_metrics(theirs)
    assert ours == theirs


def test_table_transposes_and_prints():
    table = ra.Table.from_columns({"class": ["a", "b"], "x": [0.25, 55.0], "n": [0, 55]})
    assert len(table) == 2 and table.column("x") == [0.25, 55.0]
    flipped = table.rename(columns={"x": "y"}).T
    assert flipped.index == ["class", "y", "n"] and flipped.columns == [0, 1]
    assert flipped.rows == [["a", "b"], [0.25, 55.0], [0, 55]]
    assert flipped.head(1).rows == [["a", "b"]] and flipped.tail(2).index == ["y", "n"]
    text = table.to_markdown().splitlines()
    assert text[0].split("|")[1:-1] == [" " * 3, " class ", " x    ", " n  "]
    assert [c.strip() for c in text[3].split("|")[1:-1]] == ["1", "b", "55", "55"]


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _numbers(text: str) -> list:
    return [float(v) for v in _NUMBER.findall(text)]


@pytest.mark.parametrize("argv", [["-p"], ["-p", "-c"],
                                  ["-r", "min_confidence", "0.7", "min_contour_area", "55"]])
def test_evaluate_metrics_prints_the_jax_tables(tmp_path, capsys, argv):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(make_results()))
    jax_em.main(jax_em.build_parser().parse_args([str(path), *argv]))
    want = capsys.readouterr().out
    em.main(em.build_parser().parse_args([str(path), *argv]))
    got = capsys.readouterr().out
    # the same titles, in the same order
    assert [line for line in got.splitlines() if line.startswith("#")] == \
        [line for line in want.splitlines() if line.startswith("#")]
    got_n, want_n = _numbers(got), _numbers(want)
    assert len(got_n) == len(want_n) > 40
    np.testing.assert_allclose(got_n, want_n, rtol=1e-5, atol=1e-9)


def test_extract_results_subset_matches_jax(tmp_path):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(make_results(1)))
    subset = tmp_path / "subset.txt"
    subset.write_text("page_a.png\npage_c.png\n")
    for cli, out in ((jax_subset, "jax.json"), (subset_cli, "port.json")):
        cli.main(cli.build_parser().parse_args([str(path), str(subset), "-o",
                                                str(tmp_path / out)]))
    ours = json.loads((tmp_path / "port.json").read_text())
    assert ours == json.loads((tmp_path / "jax.json").read_text())
    assert set(ours["runs"][0]["detailed_dice_scores"]) == {"page_a", "page_c"}


def test_plot_metrics_writes_the_jax_file_names(tmp_path):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(make_results(2)))
    for cli, out in ((jax_plot, "jax"), (plot_cli, "port")):
        cli.main(cli.build_parser().parse_args([str(path), str(tmp_path / out), "-c"]))
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 4 * 3 + 4  # per metric: 3 hyperparameters + per image
    from PIL import Image

    with Image.open(tmp_path / "port" / "iou_by_min_confidence.png") as image:
        colours = np.unique(np.asarray(image).reshape(-1, 3), axis=0)
        assert image.size == (640, 480) and len(colours) > 2


def _write_pairs(root, n: int = 3, size: int = 32):
    rs = np.random.RandomState(4)
    colours = {"printed_text": (0, 0, 255), "handwritten_text": (255, 0, 0)}
    for i in range(n):
        image = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
        label = np.zeros((size, size, 3), np.uint8)
        for k, colour in enumerate(colours.values()):
            for _ in range(i + 1):
                y, x = rs.randint(0, size - 6, 2)
                label[y:y + 3 + k, x:x + 4] = colour
        write_png(root / f"pair_{i}.png", np.concatenate([image, label], axis=1))


def test_coco_dataset_matches_jax(tmp_path):
    _write_pairs(tmp_path)
    colours = json.loads(open("configs/handwriting_colors.json").read())
    coco = create_coco_gt_from_image_root(tmp_path, colours)
    for size in (None, 16):
        ours = COCODataset(coco, root=tmp_path, image_size=size)
        theirs = JaxCOCODataset(coco, root=tmp_path, image_size=size)
        assert len(ours) == len(theirs) == 3 and ours.categories == theirs.categories
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            assert got["annotations"] == want["annotations"] and got["annotations"]
            assert int(got["image_id"]) == int(want["image_id"])
            # PIL's BILINEAR shrink against the port's antialiased resize:
            # one uint8 level at most
            tol = 1e-6 if size is None else 2 / 255 + 1e-6
            np.testing.assert_allclose(got["images"].numpy(), want["images"], rtol=0, atol=tol)
        batch = COCODataset.collate_func([ours[0], ours[2]])
        ref = JaxCOCODataset.collate_func([theirs[0], theirs[2]])
        assert batch["annotations"] == ref["annotations"]
        assert batch["image_id"].dtype == torch.int64
        np.testing.assert_array_equal(batch["image_id"].numpy(), ref["image_id"])
        assert tuple(batch["images"].shape) == ref["images"].shape


def test_results_clis_run_without_pandas_or_matplotlib(tmp_path):
    """The three CLIs end to end in an interpreter where pandas and
    matplotlib cannot be imported (the card machine has neither)."""
    import subprocess
    import sys

    path = tmp_path / "results.json"
    path.write_text(json.dumps(make_results(3)))
    (tmp_path / "subset.txt").write_text("page_a\n")
    script = (
        "import sys; sys.modules['pandas'] = None; sys.modules['matplotlib'] = None\n"
        "from synthesis_in_style_tpu_torch.cli import evaluate_metrics as e, plot_metrics as p\n"
        "from synthesis_in_style_tpu_torch.cli import extract_results_subset as s\n"
        f"e.main(e.build_parser().parse_args(['{path}', '-p', '-c']))\n"
        f"p.main(p.build_parser().parse_args(['{path}', '{tmp_path / 'figures'}']))\n"
        f"s.main(s.build_parser().parse_args(['{path}', '{tmp_path / 'subset.txt'}']))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "# DocUFCN - iou" in out.stdout and (tmp_path / "subset_results.json").exists()
    assert len(list((tmp_path / "figures").iterdir())) == 16
