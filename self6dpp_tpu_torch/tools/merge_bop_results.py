"""Merge per-object BOP19 result CSVs into one (port of
tools/merge_bop_results.py): the rows of every input, one per (scene_id,
im_id, obj_id) (the higher score wins a duplicate; the first file's row a
tie), sorted by that key, written as engine/evaluator.py::save_bop_csv
writes a CSV.

    python -m self6dpp_tpu_torch.tools.merge_bop_results OUT.csv \\
        IN1.csv IN2.csv ...
"""

from __future__ import annotations

import argparse


def merge(paths: list[str]) -> list[dict]:
    from ..engine.evaluator import load_bop_csv

    best: dict[tuple, dict] = {}
    for p in paths:
        for row in load_bop_csv(p):
            key = (row["scene_id"], row["im_id"], row["obj_id"])
            if key not in best or row["score"] > best[key]["score"]:
                best[key] = row
    return sorted(best.values(),
                  key=lambda r: (r["scene_id"], r["im_id"], r["obj_id"]))


def main(argv=None) -> list[dict]:
    """Writes the merged CSV; returns its rows."""
    from ..engine.evaluator import save_bop_csv

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("inputs", nargs="+")
    a = ap.parse_args(argv)
    rows = merge(a.inputs)
    save_bop_csv(a.out, rows)
    print(f"merged {len(a.inputs)} files -> {a.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
