"""BENCHMARK.json against the contract, and every file it names.

    python -m pytest portbench/tests
"""

import json
import os
import re

import pytest

from portbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIG_FILES = sorted(os.listdir(os.path.join(ROOT, "portbench", "configs")))


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and c["reduced"] == []
        assert set(c) == {"name", "source", "file", "reduced", "why"}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_configuration_run(config):
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert data["dtype"] == "bfloat16" and data["max_faces"] == 32
    assert data["canvas"] == [640, 640] and data["pre_nms_topk"] == 512
    assert data["assumed"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_resolves_by_name(name):
    cell = spec.cell(name)
    assert cell["chips"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"memory_peak_gib", "setup_s"}
    assert cell["limits"], "every compared number has its limit"
    for m in cell["per_layer"]:
        assert spec.reader(m["name"]).read is not None
    assert cell["traffic"]["name"] == [w for w in BENCH["workloads"]
                                       if w["name"] == name][0]["traffic"]


def test_cells_in_order_and_configs_used():
    assert WORKLOADS == ["buffalo_l.crowd"]
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(metric):
    mod = spec.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (metric["layer"], metric["unit"], metric["moves"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", []):
        assert w in WORKLOADS


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] == 0.25


def test_every_data_file_is_named():
    """Each file BENCHMARK.json names is there; a configuration and limits
    kept for a cell left out (``mobile_facenet.crowd``) are the only
    others."""
    named = {os.path.basename(c["file"]) for c in BENCH["configs"]}
    assert set(CONFIG_FILES) == named | {"mobile_facenet.json"}
    traffic = {f"{w['traffic']}.json" for w in BENCH["workloads"]}
    assert set(os.listdir(os.path.join(ROOT, "portbench", "traffic"))) == traffic
    limits = {f"{w}.json" for w in WORKLOADS}
    assert set(os.listdir(os.path.join(ROOT, "portbench", "limits"))) == limits | {
        "mobile_facenet.crowd.json"}
    readers = {f"{m['name']}.py" for m in BENCH["per_layer"]}
    found = {f for f in os.listdir(os.path.join(ROOT, "portbench", "metrics")) if f.endswith(".py")}
    assert found == readers


def _file(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
        return json.load(f)


def _port_modules(file: dict) -> list:
    """(the reference's module from the file's widths, the port's module)
    for each model the configuration runs."""
    from facerecognition_infrenceengine_tpu_torch.engine import pipeline as port
    from facerecognition_infrenceengine_tpu_torch.models import genderage, landmark106, scrfd

    from portbench.reference.pipeline import detector_factory, embedder_factory, head_factory

    det = file["detector"]
    pairs = [(detector_factory(det), lambda: scrfd.SCRFD(scrfd.CONFIGS[det["arch"]])),
             (embedder_factory(file["recognizer"]), port._EMBEDDERS[file["recognizer"]["arch"]])]
    ports = {"genderage": genderage.GenderAge, "landmark_2d_106": landmark106.Landmark106}
    for name, head in (file["attribute_heads"] or {}).items():
        pairs.append((head_factory(name, head), ports[name]))
    return pairs


@pytest.mark.parametrize("config", CONFIG_FILES)
def test_stated_widths_are_the_ports(config):
    """The reference's modules, built from the file's widths, hold the port's
    leaves in the port's shapes: a width the file misstates shows here, and
    in a run, where the port cannot load the weights drawn for it."""
    from portbench import data

    for ours, theirs in _port_modules(_file(config)):
        assert data.layout(ours) == data.layout(theirs)


@pytest.mark.parametrize("where,key,value", [
    ("recognizer", "stem_width", 128), ("recognizer", "sep_width", 256),
    ("recognizer", "embed_dim", 128), ("genderage", "widths", [32, 64, 128, 128])],
    ids=["mbf_stem", "mbf_tail", "mbf_embedding", "genderage"])
def test_a_misstated_width_is_refused(where, key, value):
    """A width the frozen module fixes raises; one it takes is built, and no
    longer matches the port."""
    import copy

    from portbench import data

    file = copy.deepcopy(_file("mobile_facenet.json" if where == "recognizer"
                               else "buffalo_l.json"))
    if where == "recognizer":
        file["recognizer"][key] = value
    else:
        file["attribute_heads"][where][key] = value
    try:
        pairs = _port_modules(file)
        mismatched = [data.layout(ours) != data.layout(theirs) for ours, theirs in pairs]
    except ValueError:
        return
    assert any(mismatched)
