"""Offline grouped analysis of predictions.csv: overall / ego / night /
per-category AUCs.

Port of simple_tad_tpu/eval/analysis.py on the ``csv`` module and numpy
(the JAX package's uses pandas and scikit-learn, which the port does not
need).  Reference: anaysis/metrics_dota.py:36-188, metrics_dada.py,
metrics_by_categories.py:17, and the annotation step
data_tools/{dota,dada}/anno_for_predictions.py.  A table is a dict
{column: list of values}; CSV files are read and written with the JAX
module's columns, a cell read as pandas reads it (an int or a float where
it is a number, True / False, None where it is empty, else text).

Reported metric triple per group: auroc / aucmcc / mcc05, x100 (the
paper's table format).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from simple_tad_tpu_torch.eval.metrics import (THRESHOLDS, mcc_curve,
                                               risk_probs, roc_auc_score)

DOTA_CAT_CODES = ("ST", "AH", "LA", "OC", "TC", "VP", "VO", "OO", "UK")
ANNO_COLUMNS = ("clip", "filename", "label", "ego", "night", "cat",
                "clip_lvl_cat", "clip_lvl_ego")
# the columns of an annotation table that the join carries over
_JOINED = ("ego", "night", "clip_lvl_cat", "clip_lvl_ego")
# the cells pandas.read_csv reads as missing
_MISSING = {"", "NA", "N/A", "NaN", "nan", "NULL", "null", "None", "n/a",
            "<NA>", "-NaN", "-nan", "#N/A", "#NA", "1.#IND", "1.#QNAN",
            "-1.#IND", "-1.#QNAN", "#N/A N/A"}

Table = Dict[str, list]


def build_frame_annotations(dataset) -> Table:
    """Per-window annotation table {clip, filename, label, ego, night, cat,
    clip_lvl_cat, clip_lvl_ego} of a test-mode FrameDataset, one row a
    window (its last frame) - the anno_for_predictions.py equivalent."""
    rows: Table = {c: [] for c in ANNO_COLUMNS}
    for view in dataset.clip_eval_views():
        clip = view.clip
        last = view.unique_frames[view.window_idx[:, -1]]
        for i, fname in enumerate(view.frame_names):
            fi = last[i]
            for col, value in (
                    ("clip", clip.name), ("filename", fname),
                    ("label", int(clip.binary_labels[fi])),
                    ("ego", int(clip.ego)), ("night", int(clip.night)),
                    ("cat", int(clip.cat_labels[fi])),
                    ("clip_lvl_cat", clip.meta_category or "UK"),
                    ("clip_lvl_ego", bool(clip.meta_ego)
                     if clip.meta_ego is not None else bool(clip.ego))):
                rows[col].append(value)
    return rows


def _cell(text: str):
    if text in _MISSING:
        return None
    if text in ("True", "False"):
        return text == "True"
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def read_table(path: str) -> Table:
    """A CSV file with a header line -> {column: values}."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = [[] for _ in header]
        for row in reader:
            for col, text in zip(cols, row):
                col.append(_cell(text))
    return dict(zip(header, cols))


def write_table(table: Table, path: str) -> None:
    """{column: values} -> a CSV file, laid out as pandas.to_csv(index=False)
    writes it."""
    cols = list(table)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(cols)
        writer.writerows(zip(*(table[c] for c in cols)))


def _missing(value) -> bool:
    return value is None or (isinstance(value, float) and value != value)


def _join(preds: Table, anno: Table) -> Table:
    """The left join of ``preds`` with ``anno``'s annotation columns on
    (clip, filename), then the rows with a missing value dropped (the JAX
    module's merge(how='left') and dropna)."""
    keep = [c for c in _JOINED if c in anno]
    index: Dict[tuple, List[int]] = {}
    for j, key in enumerate(zip(anno["clip"], anno["filename"])):
        index.setdefault(key, []).append(j)
    cols = list(preds) + [c for c in keep if c not in preds]
    out: Table = {c: [] for c in cols}
    n = len(preds["clip"])
    for i in range(n):
        matches = index.get((preds["clip"][i], preds["filename"][i]), [None])
        for j in matches:
            row = {c: preds[c][i] for c in preds}
            for c in keep:
                row[c] = None if j is None else anno[c][j]
            if any(_missing(v) for v in row.values()):
                continue
            for c in cols:
                out[c].append(row[c])
    return out


def _group_metrics(labels, probs) -> Dict[str, float]:
    """auroc / aucmcc / mcc05; single-class groups get the reference's
    sentinel AUC (-10 - y, anaysis/metrics.py:55-61)."""
    labels = np.asarray(labels)
    if len(np.unique(labels)) < 2:
        y = int(labels[0]) if len(labels) else 0
        return {"auroc": -10 - y, "aucmcc": 0.0, "mcc05": 0.0,
                "n": len(labels)}
    mcc = mcc_curve(probs, labels)
    idx05 = int(np.argmin(np.abs(THRESHOLDS - 0.5)))
    return {"auroc": float(roc_auc_score(labels, probs)),
            "aucmcc": float(np.trapezoid(mcc, THRESHOLDS)),
            "mcc05": float(mcc[idx05]), "n": len(labels)}


def grouped_metrics(preds: Table, anno: Optional[Table] = None, *,
                    cat_codes=DOTA_CAT_CODES) -> Dict[str, Dict[str, float]]:
    """Join predictions with annotations and compute per-group metrics.

    ``preds`` needs columns {clip, filename, logits_safe, logits_risk,
    label}; ``anno`` (optional) {clip, filename, ego, night, clip_lvl_cat,
    clip_lvl_ego}.  Returns {group_name: {auroc, aucmcc, mcc05, n}}."""
    table = dict(preds) if anno is None else _join(preds, anno)
    probs = risk_probs(table["logits_safe"], table["logits_risk"])
    labels = np.asarray(table["label"])

    def group(sel):
        return _group_metrics(labels[sel], probs[sel])

    out = {"TOTAL": group(np.ones(len(labels), bool))}
    for col, names in (("ego", ("ego", "non-ego")),
                       ("night", ("night", "day"))):
        if col in table:
            values = np.asarray(table[col])
            for name, want in zip(names, (1, 0)):
                sel = values == want
                if sel.any():
                    out[name] = group(sel)
    if "clip_lvl_cat" in table:
        cats = table["clip_lvl_cat"]
        for code in cat_codes:
            sel = np.array([c == code for c in cats], bool)
            if sel.any():
                out[f"cat:{code}"] = group(sel)
    return out


def format_group_report(groups: Dict[str, Dict[str, float]]) -> str:
    lines = ["=" * 59, "  Grouped metrics (auroc / aucmcc / mcc05, x100)",
             "-" * 59]
    for name, m in groups.items():
        lines.append(
            f"{name:>12}  n={m['n']:>7}  auroc: {100 * m['auroc']:.1f} | "
            f"aucmcc: {100 * m['aucmcc']:.1f} | mcc05: {100 * m['mcc05']:.1f}")
    return "\n".join(lines)


def show_metrics(preds_dir: str, dataset=None,
                 anno_csv: Optional[str] = None) -> str:
    """metrics_dota.show_metrics equivalent: read predictions.csv, join with
    annotations (from a dataset or a CSV), write group_metrics.txt."""
    preds = read_table(os.path.join(preds_dir, "predictions.csv"))
    anno = None
    if dataset is not None:
        anno = build_frame_annotations(dataset)
    elif anno_csv is not None:
        anno = read_table(anno_csv)
    report = format_group_report(grouped_metrics(preds, anno))
    with open(os.path.join(preds_dir, "group_metrics.txt"), "w") as f:
        f.write(report + "\n")
    return report
