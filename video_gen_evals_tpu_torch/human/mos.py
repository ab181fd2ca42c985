"""Human MOS processing — ref ``process_human_scores.py`` equivalent (C31).

Copy of ``video_gen_evals_tpu/human/mos.py`` (numpy and scipy only; the port
loads nothing of the JAX package). Three-stage rater filtering followed by
per-video MOS + z-score:

1. repeated-video consistency: keep participants whose mean per-video rating
   std over repeated videos is within the 95th percentile (ref ``:41-83``);
2. subject rejection via R1/R2 statistics with a kurtosis-dependent threshold
   (sqrt(20)*sigma if leptokurtic else 2*sigma), minimum 10 ratings
   (ref ``:85-124``);
3. inter-rater reliability: Spearman >= 0.55 against the leave-one-out mean
   of all other raters (ref ``:126-176``);

then MOS per video, z-score normalized (ref ``:178-202``). Names are
normalized by :func:`video_gen_evals_tpu_torch.utils.names.norm_name`.

Metric keys follow the raw data: ``action_consistency`` / MOS "ac",
``physical_plausibility`` / MOS "tc".

    python -m video_gen_evals_tpu_torch.human.mos --input raw.csv --output human_scores.json
"""

from __future__ import annotations

import csv
import json
import typing as T
from collections import defaultdict

import numpy as np

from ..utils.names import norm_name

Row = T.Dict[str, T.Any]
ParticipantData = T.Dict[str, T.List[Row]]

AC_KEY = "action_consistency"
TC_KEY = "physical_plausibility"


def load_raw_rows(filepath: str) -> T.Tuple[T.List[Row], ParticipantData]:
    """CSV (or JSON list-of-dicts) with participant_id, video_id, and the two
    metric columns."""
    rows: T.List[Row] = []
    if filepath.endswith(".json"):
        with open(filepath) as f:
            raw = json.load(f)
        for r in raw:
            r = dict(r)
            r[AC_KEY] = float(r[AC_KEY])
            r[TC_KEY] = float(r[TC_KEY])
            rows.append(r)
    else:
        with open(filepath) as f:
            for r in csv.DictReader(f):
                r[AC_KEY] = float(r[AC_KEY])
                r[TC_KEY] = float(r[TC_KEY])
                rows.append(r)
    participants: ParticipantData = defaultdict(list)
    for r in rows:
        participants[r["participant_id"]].append(r)
    return rows, dict(participants)


def stage1_repeated_video_consistency(
    participant_data: ParticipantData,
) -> ParticipantData:
    participant_stds: T.Dict[str, float] = {}
    for pid, rows in participant_data.items():
        per_video: T.Dict[str, T.List[Row]] = defaultdict(list)
        for r in rows:
            per_video[r["video_id"]].append(r)
        stds = []
        for ratings in per_video.values():
            if len(ratings) > 1:
                stds.append(np.std([r[AC_KEY] for r in ratings]))
                stds.append(np.std([r[TC_KEY] for r in ratings]))
        participant_stds[pid] = float(np.mean(stds)) if stds else 999.0

    if not participant_stds:
        return participant_data
    threshold = np.percentile(list(participant_stds.values()), 95)
    return {
        pid: rows
        for pid, rows in participant_data.items()
        if participant_stds[pid] <= threshold
    }


def stage2_subject_rejection(
    participant_data: ParticipantData, metric: str = AC_KEY
) -> ParticipantData:
    from scipy.stats import kurtosis   # imported here: scipy.stats loads slowly

    all_scores = [r[metric] for rows in participant_data.values() for r in rows]
    pop_mean = np.mean(all_scores)
    pop_std = np.std(all_scores)
    threshold = (
        np.sqrt(20) * pop_std if kurtosis(all_scores) > 3 else 2 * pop_std
    )

    valid: ParticipantData = {}
    for pid, rows in participant_data.items():
        if len(rows) < 10:
            continue
        scores = np.array([r[metric] for r in rows])
        Pi = int(np.sum(scores > pop_mean + threshold))
        Qi = int(np.sum(scores < pop_mean - threshold))
        Ni = len(scores)
        R1 = (Pi + Qi) / Ni if Ni > 0 else 1.0
        R2 = abs(Pi - Qi) / (Pi + Qi) if (Pi + Qi) > 0 else 0.0
        if not (R1 > 0.05 and R2 < 0.3):
            valid[pid] = rows
    return valid


def stage3_inter_rater_reliability(
    participant_data: ParticipantData,
    metric: str = AC_KEY,
    correlation_threshold: float = 0.55,
) -> ParticipantData:
    from scipy.stats import spearmanr

    valid: ParticipantData = {}
    for pid, rows in participant_data.items():
        mine = {r["video_id"]: r[metric] for r in rows}
        if len(mine) < 3:
            continue
        others: T.Dict[str, T.List[float]] = defaultdict(list)
        for opid, orows in participant_data.items():
            if opid == pid:
                continue
            for r in orows:
                others[r["video_id"]].append(r[metric])
        other_means = {v: np.mean(s) for v, s in others.items() if s}
        common = [v for v in mine if v in other_means]
        if len(common) < 3:
            continue
        corr, _ = spearmanr(
            [mine[v] for v in common], [other_means[v] for v in common]
        )
        if not np.isnan(corr) and corr >= correlation_threshold:
            valid[pid] = rows
    return valid


def compute_mos_and_normalize(
    participant_data: ParticipantData, metric: str = AC_KEY
) -> T.Dict[str, float]:
    by_video: T.Dict[str, T.List[float]] = defaultdict(list)
    for rows in participant_data.values():
        for r in rows:
            by_video[r["video_id"]].append(r[metric])
    mos = {v: float(np.mean(s)) for v, s in by_video.items()}
    values = list(mos.values())
    mean, std = np.mean(values), np.std(values)
    return {
        v: float((m - mean) / std) if std > 0 else 0.0 for v, m in mos.items()
    }


def normalize_video_id(video_id: str) -> str:
    """norm_name + re-appended .mp4 (ref ``process_human_scores.py:204-228``)."""
    return norm_name(video_id) + ".mp4"


def process_human_scores(
    input_file: str, output_file: T.Optional[str] = None
) -> T.Dict[str, T.Dict[str, float]]:
    """Full pipeline: raw ratings -> filtered, z-scored MOS per video."""
    _rows, participants = load_raw_rows(input_file)
    s1 = stage1_repeated_video_consistency(participants)
    s2_ac = stage2_subject_rejection(s1, AC_KEY)
    s2_tc = stage2_subject_rejection(s1, TC_KEY)
    s3_ac = stage3_inter_rater_reliability(s2_ac, AC_KEY)
    s3_tc = stage3_inter_rater_reliability(s2_tc, TC_KEY)
    mos_ac = compute_mos_and_normalize(s3_ac, AC_KEY)
    mos_tc = compute_mos_and_normalize(s3_tc, TC_KEY)

    out: T.Dict[str, T.Dict[str, float]] = {}
    for vid in set(mos_ac) | set(mos_tc):
        out[normalize_video_id(vid)] = {
            "ac": float(mos_ac.get(vid, 0.0)),
            "tc": float(mos_tc.get(vid, 0.0)),
        }
    if output_file:
        with open(output_file, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: T.Optional[T.List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Process raw human ratings into MOS")
    p.add_argument("--input", default="raw_humans.csv")
    p.add_argument("--output", default="human_scores.json")
    args = p.parse_args(argv)
    out = process_human_scores(args.input, args.output)
    print(f"Saved {len(out)} videos to {args.output}")


if __name__ == "__main__":
    main()
