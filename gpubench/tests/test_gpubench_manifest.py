"""``BENCHMARK.json`` keeps to the benchmark's contract, and every part of
a cell is found by its name, also one added as new files only."""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import harness, systems  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_LIMIT = 200


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= TEXT_LIMIT and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_text_ok(w) for w in bench["command"])
    for w in bench["command"][1:]:
        assert not w.startswith("/") and ".." not in w
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in bench[key]}) == len(bench[key])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
    assert len({(w["config"], w["traffic"])
                for w in bench["workloads"]}) == len(bench["workloads"])
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["configs"]) <= 24


def test_metrics_keys_sources_and_bounds(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text_ok(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    for m in bench["per_layer"]:
        cells = m.get("workloads") or [w["name"] for w in bench["workloads"]]
        for cell in cells:
            e2e, layer = harness.cell_metrics(bench, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)
            assert m["name"] in {x["name"] for x in layer}


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        e2e, layer = harness.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer


def test_every_configuration_is_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_part_of_every_cell_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell, cfg, mix, limits = harness.cell_parts(bench, w["name"])
        assert cfg["name"] == w["config"]
        assert callable(systems.kind(mix["kind"]).System) and limits
        assert os.path.exists(os.path.join(ROOT, cfg["weights"]))
        _, layer = harness.cell_metrics(bench, w["name"])
        for m in layer:
            assert callable(harness.reader(m["name"]))


# a new kind of loop: the serving loop of this copy, with one number more
KIND = """
import os
from gpubench import systems

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class System(systems.kind("serve", ROOT).System):
    def check(self):
        return dict(super().check(), marked=1.0)
"""


@pytest.mark.parametrize("kind,setting", [
    ("serve", {"patch_inference": True}), ("serve", {"fg_crop": True}),
    ("serve", {"serve_scan": 4}), ("serve", {"largest_cc": True}),
    ("serve", {"use_int8": True, "int8_adaquant": True}),
    ("train", {"train_patch_size": 64}), ("train", {"fg_crop_train": True}),
])
def test_a_loop_refuses_a_setting_it_does_not_follow(kind, setting):
    """A configuration that sets a path the loop does not follow is
    refused, not measured under the cell's name."""
    import torch

    cfg = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                      "unetsp.json")))
    cfg["settings"].update(setting)
    mix = json.load(open(os.path.join(
        ROOT, "gpubench", "mixes",
        {"serve": "serve_stream", "train": "train_steps"}[kind] + ".json")))
    with pytest.raises(NotImplementedError, match=sorted(setting)[0]):
        systems.kind(kind).System(cfg, mix, 1, torch.device("cpu"),
                                  (32, 48, 48))


def _copy_benchmark(dst: str) -> None:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "gpubench"),
                    os.path.join(dst, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__"))


def _contents(top: str):
    out = {}
    for dp, _, fs in os.walk(top):
        for f in fs:
            if not f.endswith(".pyc"):
                path = os.path.join(dp, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, top)] = fh.read()
    return out


def test_a_new_config_mix_and_metric_are_picked_up_from_files(tmp_path):
    """A configuration, a mix of a new kind of loop and a per-layer metric
    added as new files and entries in a copy are found and run, no file of
    it edited."""
    root = str(tmp_path)
    _copy_benchmark(root)
    gb = os.path.join(root, "gpubench")
    before = _contents(gb)
    cfg = json.load(open(os.path.join(gb, "configs", "unetsp.json")))
    cfg.update(name="tinysp", canvas=[16, 32, 32])
    json.dump(cfg, open(os.path.join(gb, "configs", "tinysp.json"), "w"))
    json.dump({"kind": "serve_marked", "volumes": 2, "warmup": 2,
               "sample": 2, "trace_units": 2},
              open(os.path.join(gb, "mixes", "pair.json"), "w"))
    with open(os.path.join(gb, "kinds", "serve_marked.py"), "w") as f:
        f.write(KIND)
    with open(os.path.join(gb, "metrics", "volumes_traced.py"), "w") as f:
        f.write("def read(view):\n    return float(view.units)\n")
    json.dump({"flip_share_worst": 1.0},
              open(os.path.join(gb, "limits", "tinysp.pair.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(name="tinysp", source="a test",
                                 file="gpubench/configs/tinysp.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="tinysp.pair", config="tinysp",
                                   traffic="pair", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "serve_volumes_per_s":
            m["workloads"].append("tinysp.pair")
    bench["per_layer"].append(dict(
        name="volumes_traced", unit="volumes", better="higher",
        source="program_counter", layer="a test",
        moves="serve_volumes_per_s", workloads=["tinysp.pair"]))
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    import torch

    result = harness.run_cell("tinysp.pair", 7, 0.5, True,
                              torch.device("cpu"), time.perf_counter(),
                              root=root)
    assert result["metrics"]["volumes_traced"]["value"] == 2.0
    assert result["correct"] is True
    assert result["numbers"]["marked"] == 1.0
    after = _contents(gb)
    assert {k: after[k] for k in before} == before


def test_flops_counts_the_published_widths():
    """UNetSP at 224x304x304: 6.93e11 FLOPs a forward volume."""
    from gpubench import flops

    spec = dict(n_blocks=4, i_size=7, input_channels=2, out_channels=3,
                head="double")
    fwd = flops.forward_flops(spec, (224, 304, 304))
    assert math.isclose(fwd, 6.934e11, rel_tol=2e-3)
    layers = flops.layers(spec, (224, 304, 304))
    assert len(layers) == 1 + 3 * 4 + 2 * 4 + 1
    assert sum(r["ops"] for r in layers) >= fwd
