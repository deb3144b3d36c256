"""``BENCHMARK.json`` keeps to the contract's shapes and names, and every
file it implies is there."""

import json
import re
from pathlib import Path

import pytest

from portbench.harness import weights
from portbench.harness.spec import HERE, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expansion|d_ff|d_model|moe_k")

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NUMBERS = {"loss_gap", "grad_gap", "grad_diff", "change_gap"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_portbench_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / word).exists()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_portbench_names_are_plain_and_unique(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_portbench_metric_names_are_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_portbench_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_portbench_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_portbench_per_layer_moves_a_metric_each_cell_reports():
    spec = Spec(BENCH)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert m["moves"] in {e["name"] for e in spec.end_to_end(w)}
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_portbench_every_cell_reports_enough_and_has_its_files():
    spec = Spec(BENCH)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(w["name"])
        limits = spec.limits(w["name"])
        assert limits and set(limits) <= NUMBERS
        assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    assert configs == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_portbench_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/") and _line(entry["source"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(entry["file"]) == 1
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["name"] == entry["name"]
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    assert weights.count(cfg) == cfg["parameters"]


def test_portbench_files_under_paths_are_named_from_name_characters():
    for p in Path(HERE).rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel


def test_portbench_big_sizes_are_the_published_ones():
    # arXiv 1706.03762, Table 3, "big": N 6, d_model 1024, d_ff 4096, h 16, d_k 64
    cfg = Spec(BENCH).config("seqformer_big")
    assert (cfg["d_model"], cfg["n_heads"], cfg["n_layers"], cfg["d_ff"]) == (1024, 16, 6, 4096)
    assert cfg["d_model"] // cfg["n_heads"] == 64
    assert cfg["assumed"] == ["obs_dim", "max_len", "lr"]
    assert cfg["parameters"] == 76_170_272
