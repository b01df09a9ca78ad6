"""The readings that set a cell's limits, in one process: the port's
compared numbers on many seeds (the lower readings), the control's and the
planted faults' (the upper readings).  Not part of a benchmark run.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--seconds 3] [--control fp8|int8|none] [--faults]

Each seed serves a short window at the cell's own load, then the sample the
run would judge is judged.  ``--control fp8``: the reference with float8
e4m3 convs and dense layers, and decisions on the gallery in the precision
below the cell's (bfloat16 for float32, int4 for int8), put in the port's
place on the same frames.  ``--control int8``: the same seed served again
with the port's own int8 path switched on (``embed_int8``, ``det_int8``).
``--faults``: the port's own answers altered where they are produced, one
fault a set (half of a frame's faces left out, a gender flipped, a person
swapped for the runner-up, a similarity moved by 0.01, a recognized flag
inverted), and two faults of detection planted in the float32 reference
put in the port's place (NMS left out; every fourth slot from under the
threshold).  One JSON line a seed and set on standard output.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOWER = {"float32": "bfloat16", "int8": "int4"}


def control_outputs(cell: dict, d, sample: list, device, kind: str = "fp8") -> list:
    """The reference put in the port's place on the sampled frames: its
    faces and decisions.  ``fp8``: float8 e4m3 convs and dense layers, and
    decisions on the gallery one precision below the cell's.  Two faults
    of detection, planted in the float32 reference, each face embedded (and
    its attributes read) where it is served: ``no_nms``, the top
    ``max_faces`` candidates by score served with NMS left out;
    ``under_threshold``, every fourth slot served from the anchors the
    reference scores best under the detection threshold."""
    from portbench import bench, check
    from portbench.reference.pipeline import Reference, canvas_of

    config, traffic = cell["config"], cell["traffic"]
    fp8 = kind == "fp8"
    below = LOWER[traffic["engine"].get("gallery_dtype", "float32")] if fp8 else None
    gallery = bench.site_gallery(cell, d, below)
    cref = Reference(config, d.det, d.rec, device, fp8=fp8)
    out = []
    for f in sample:
        canvas = canvas_of(d.pool[f.pool_index], config["canvas"], traffic["transport"])[None]
        det = cref.detect(canvas)
        if kind == "no_nms":
            k = config["max_faces"]
            live = np.isfinite(det["cand_scores"][0][:k])
            kps, boxes = det["cand_kps"][0][:k][live], det["cand_boxes"][0][:k][live]
            scores = det["cand_scores"][0][:k][live]
        else:
            valid = det["valid"][0]
            kps, boxes, scores = det["kps"][0][valid], det["boxes"][0][valid], det["scores"][0][valid]
        kps, boxes, scores = kps.copy(), boxes.copy(), scores.copy()
        if kind == "under_threshold":
            every = det["all_scores"][0]
            order = np.argsort(-np.where(every < config["det_thresh"], every, -np.inf),
                               kind="stable")
            for n, slot in enumerate(range(0, len(boxes), 4)):
                a = order[n]
                boxes[slot], kps[slot] = det["all_boxes"][0][a], det["all_kps"][0][a]
                scores[slot] = every[a]
        idx = np.zeros(len(kps), np.int64)
        embs = cref.embed(canvas, idx, kps)
        faces = [dict(bbox=boxes[k], kps=kps[k], score=float(scores[k]), emb=embs[k],
                      gender=None, age=None, lm=None) for k in range(len(kps))]
        if config.get("attribute_heads"):
            logits, age, lm = cref.attributes(canvas, idx, boxes)
            for k, face in enumerate(faces):
                face.update(gender=int(np.argmax(logits[k])), age=int(np.round(age[k])),
                            lm=lm[k])
        out.append((f.pool_index, faces,
                    check.reference_decisions(gallery, embs, traffic["recognition_threshold"])))
    return out


def faults(judged: list, gallery) -> dict:
    """The port's answers with one fault planted in each set's first face
    of every frame (or, for "drop_half", half of every frame's faces)."""
    out = {}

    def plant(name, fn):
        sets = copy.deepcopy(judged)
        for _, faces, decided in sets:
            if faces:
                fn(faces, decided)
        out[name] = sets

    def drop(faces, decided):
        del faces[len(faces) // 2:], decided[len(decided) // 2:]

    def gender(faces, _decided):
        if faces[0]["gender"] is not None:
            faces[0]["gender"] = 1 - int(faces[0]["gender"])

    def swap(faces, decided):
        order = np.argsort(-gallery.scores(faces[0]["emb"][None])[0])
        decided[0].update(person_id=gallery.ids[int(order[1])], recognized=True)

    def similarity(_faces, decided):
        decided[0]["similarity"] -= 0.01

    def flag(faces, decided):
        best = int(np.argmax(gallery.scores(faces[0]["emb"][None])[0]))
        now = not decided[0]["recognized"]
        decided[0].update(recognized=now, person_id=gallery.ids[best] if now else None)

    for name, fn in (("drop_half", drop), ("gender_flip", gender), ("swap_person", swap),
                     ("similarity", similarity), ("flag", flag)):
        plant(name, fn)
    return out


def score_summary(cell: dict, d, sample: list) -> dict:
    """How the sample's faces were decided: the recognized share and the
    quartiles of the best score."""
    from portbench import bench

    g = bench.site_gallery(cell, d)
    best = np.concatenate([g.scores(np.stack([f.normed_embedding for f in s.faces])).max(axis=1)
                           for s in sample if s.faces])
    rec = [r["recognized"] for s in sample for r in s.results]
    return {"recognized_share": float(np.mean(rec)),
            "best_score_q": [float(x) for x in np.quantile(best, [0, 0.25, 0.5, 0.75, 1])]}


def calibrate(cell: dict, seeds: list, seconds: float, control: str, planted: bool, device,
              emit=print) -> None:
    from portbench import bench

    for seed in seeds:
        t_start = time.perf_counter()
        d = bench.prepare_data(cell["config"], cell["traffic"], seed, device)
        sides = [("port", None)] + ([("int8", {"embed_int8": True, "det_int8": True})]
                                    if control == "int8" else [])
        for side, overrides in sides:
            w = bench.serve_window(cell, d, seconds, False, device, t_start, overrides)
            e = bench.end_to_end(w)
            sample = bench.judged_sample(e.sent, seed, cell["traffic"]["check_frames"])
            extra = {}
            if side == "port" and control == "fp8":
                extra["fp8"] = control_outputs(cell, d, sample, device)
            if side == "port" and planted:
                extra.update(faults(bench.served(sample), bench.site_gallery(cell, d)))
                for kind in ("no_nms", "under_threshold"):
                    extra[kind] = control_outputs(cell, d, sample, device, kind)
            t0 = time.perf_counter()
            judged = bench.judge_port(cell, d, sample, device, extra)
            head = {"seed": seed, "faces_per_s": e.faces / e.window_s, "failed": e.failed,
                    "frames": len(sample), "judge_s": time.perf_counter() - t0,
                    **score_summary(cell, d, sample)}
            for name, nums in judged.items():
                emit(json.dumps({"side": side if name == "port" else name, **head,
                                 "numbers": nums}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("fp8", "int8", "none"), default="none")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    os.environ["FRE_WEIGHTS_DIR"] = os.path.join(ROOT, "portbench", "_weights_none")
    sys.path.insert(0, ROOT)
    from portbench import spec

    cell = spec.cell(args.workload, ROOT)
    calibrate(cell, [int(s) for s in args.seeds.split(",")], args.seconds, args.control,
              args.faults, "cuda", emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
