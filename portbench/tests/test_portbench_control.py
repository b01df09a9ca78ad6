"""The correctness check at a size a test run holds: the sound port passes
its limits; the fp8 control and a run whose timed path is broken
underneath fail them.  The harness's look for a chip is skipped: these
runs drive the rest of a run on the CPU (det_2.5g + IResNet-18, float32,
a 128 canvas, 4 faces a frame)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import bench, calibrate, check, spec

TESTS = os.path.dirname(os.path.abspath(__file__))
LIMITS_OF = "buffalo_l.crowd"  # the bf16 cell's limits, with the heads' numbers


STREAM = {"transport": "yuv420", "prepare_on_client": True,
          "engine": {"stream_transport": "yuv420", "upload_on_submit": True,
                     "packed_stem_impl": "pallas", "gallery_dtype": "int8"}}


def tiny_cell(stream: bool = False) -> dict:
    with open(os.path.join(TESTS, "tiny_config.json")) as f:
        config = json.load(f)
    with open(os.path.join(TESTS, "tiny_traffic.json")) as f:
        traffic = json.load(f)
    if stream:  # the streaming profile, which only a facade without heads takes
        traffic.update(STREAM)
        config.update(modules=["detection", "recognition"], attribute_heads=None)
    bench_ = spec.benchmark()
    limits = spec.cell(LIMITS_OF)["limits"]
    if stream:
        limits = {k: v for k, v in limits.items() if not k.startswith("attr.")}
    return {"name": "tiny", "chips": 1, "config": config, "traffic": traffic,
            "limits": limits,
            "end_to_end": bench_["end_to_end"], "per_layer": []}


def run_tiny(seed: int = 2**31 + 5, stream: bool = False) -> dict:
    torch.set_num_threads(4)
    return bench.run_cell(tiny_cell(stream), seed, 6.0, False, "cpu", time.perf_counter(),
                          log=lambda line: None)


@pytest.mark.parametrize("stream", [False, True], ids=["rgb", "yuv420"])
def test_sound_run_is_correct_and_shaped(stream):
    result = run_tiny(stream=stream)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    # the card's memory peak is an end-to-end metric that a CPU run cannot read
    assert set(result["metrics"]) == {"setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(tiny_cell(stream)["limits"])
    json.dumps(result)


def test_fp8_control_and_planted_faults_are_not_correct():
    """Seed 12: its frames' top four candidates overlap, so leaving NMS out
    changes the answer (at four faces a frame it need not)."""
    cell = tiny_cell()
    d = bench.prepare_data(cell["config"], cell["traffic"], 12, "cpu")
    w = bench.serve_window(cell, d, 6.0, False, "cpu", time.perf_counter())
    sample = bench.judged_sample(bench.end_to_end(w).sent, 12, cell["traffic"]["check_frames"])
    extra = {kind: calibrate.control_outputs(cell, d, sample, "cpu", kind)
             for kind in ("fp8", "no_nms", "under_threshold")}
    extra.update(calibrate.faults(bench.served(sample), bench.site_gallery(cell, d)))
    judged = bench.judge_port(cell, d, sample, "cpu", extra)
    sound = judged.pop("port")
    assert check.verdict(sound, cell["limits"])[0], sound
    for name, nums in judged.items():
        assert not check.verdict(nums, cell["limits"])[0], (name, nums)


def _rotate_one_embedding(monkeypatch):
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    real = FaceAnalysis._faces_from_fused_flat

    def broken(flat, n, max_num):
        per_frame = real(flat, n, max_num)
        face = per_frame[0][0]
        face.normed_embedding = np.roll(face.normed_embedding, 1)
        return per_frame

    monkeypatch.setattr(FaceAnalysis, "_faces_from_fused_flat", staticmethod(broken))


def _alter_one_decision(monkeypatch):
    from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
        FaceRecognitionProcessor)

    real = FaceRecognitionProcessor.match_faces

    def broken(self, frame, faces, company_id, draw=True):
        frame, results = real(self, frame, faces, company_id, draw=draw)
        if results:
            results[-1]["similarity"] = results[-1]["similarity"] - 0.05
        return frame, results

    monkeypatch.setattr(FaceRecognitionProcessor, "match_faces", broken)


@pytest.mark.parametrize("fault", [_rotate_one_embedding, _alter_one_decision],
                         ids=["embedding", "decision"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert run_tiny()["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_first_cell_short_run_on_the_card(card):
    cell = spec.cell("buffalo_l.crowd")
    result = bench.run_cell(cell, 2**31 + 99, 3.0, False, card, time.perf_counter(),
                            log=lambda line: None)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
