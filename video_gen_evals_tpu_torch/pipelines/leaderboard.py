"""Leaderboard generator — ref ``process_scores.py`` equivalent (C30).

Copy of ``video_gen_evals_tpu/pipelines/leaderboard.py``. Reads a
``{filename: {ac, tc}}`` scores JSON, parses (model, action) from filenames,
min-max normalizes AC/TC to 0-100 over the whole score set, aggregates per
action and per model, and writes ``comparison_table.json`` plus an ASCII
preview, with the reference's output schema byte for byte (ref
``process_scores.py:210-226``).

    python -m video_gen_evals_tpu_torch.pipelines.leaderboard --scores video_scores.json
"""

from __future__ import annotations

import json
import re
import typing as T
from collections import defaultdict

from ..utils.names import ACTION_CLASSES


def parse_filename(filename: str) -> T.Tuple[T.Optional[str], T.Optional[str]]:
    """Extract (model, action) from a score filename (ref
    ``process_scores.py:19-81``): find a known action substring; model is
    everything before it with trailing standalone numbers stripped.

    Reference quirk reproduced: the trailing-digit strip turns
    ``Opensora_768_...`` into model ``Opensora`` (the reference docstring
    claims ``Opensora_768``, but its code pops every trailing numeric
    segment; observable output wins)."""
    name = filename.replace(".mp4", "")
    parts = name.split("_")

    action = None
    action_idx = None
    for act in ACTION_CLASSES:
        if act in name:
            action = act
            action_idx = name.find(act)
            break
    if not action:
        for i in range(len(parts) - 1, -1, -1):
            if re.match(r"^[A-Z][a-z]+[A-Z][a-z]+", parts[i]):
                action = parts[i]
                break

    if action_idx:
        model_part = name[:action_idx].rstrip("_")
        model_parts = model_part.split("_")
        while model_parts and model_parts[-1].isdigit():
            model_parts.pop()
        model = "_".join(model_parts) if model_parts else model_part
    else:
        model = parts[0]
    return model, action


def normalize_to_0_100(value: float, min_val: float, max_val: float) -> float:
    if max_val == min_val:
        return 50.0
    return (value - min_val) / (max_val - min_val) * 100.0


def build_leaderboard(scores_data: T.Dict[str, T.Dict[str, float]]) -> T.Dict[str, T.Any]:
    """scores.json content -> comparison-table dict (reference schema)."""
    all_ac: T.List[float] = []
    all_tc: T.List[float] = []
    model_action: T.Dict[str, T.Dict[str, T.Dict[str, T.List[float]]]] = defaultdict(
        lambda: defaultdict(lambda: {"ac": [], "tc": []})
    )
    for filename, s in scores_data.items():
        model, action = parse_filename(filename)
        if not model or not action:
            continue
        ac, tc = s["ac"], s["tc"]
        all_ac.append(ac)
        all_tc.append(tc)
        model_action[model][action]["ac"].append(ac)
        model_action[model][action]["tc"].append(tc)

    if not all_ac:
        raise ValueError("no parseable scores")
    ac_min, ac_max = min(all_ac), max(all_ac)
    tc_min, tc_max = min(all_tc), max(all_tc)

    all_actions = sorted({a for m in model_action.values() for a in m})
    all_models = sorted(model_action)

    table: T.Dict[str, T.Dict[str, T.Dict[str, T.Optional[float]]]] = {}
    for action in all_actions:
        table[action] = {}
        for model in all_models:
            if action in model_action[model]:
                acs = model_action[model][action]["ac"]
                tcs = model_action[model][action]["tc"]
                ac_avg = sum(acs) / len(acs) if acs else 0
                tc_avg = sum(tcs) / len(tcs) if tcs else 0
                ac_n = normalize_to_0_100(ac_avg, ac_min, ac_max)
                tc_n = normalize_to_0_100(tc_avg, tc_min, tc_max)
                table[action][model] = {
                    "ac": round(ac_n, 2),
                    "tc": round(tc_n, 2),
                    "avg": round((ac_n + tc_n) / 2, 2),
                    "ac_raw": round(ac_avg, 4),
                    "tc_raw": round(tc_avg, 4),
                }
            else:
                table[action][model] = {"ac": None, "tc": None, "avg": None}

    aggregated: T.Dict[str, T.Dict[str, T.Optional[float]]] = {}
    for model in all_models:
        acs = [table[a][model]["ac"] for a in all_actions if a in model_action[model]]
        tcs = [table[a][model]["tc"] for a in all_actions if a in model_action[model]]
        avgs = [table[a][model]["avg"] for a in all_actions if a in model_action[model]]
        if acs:
            aggregated[model] = {
                "ac": round(sum(acs) / len(acs), 2),
                "tc": round(sum(tcs) / len(tcs), 2),
                "avg": round(sum(avgs) / len(avgs), 2),
            }
        else:
            aggregated[model] = {"ac": None, "tc": None, "avg": None}

    return {
        "normalization_ranges": {
            "ac": {"min": ac_min, "max": ac_max},
            "tc": {"min": tc_min, "max": tc_max},
        },
        "models": all_models,
        "actions": all_actions,
        "table_data": table,
        "aggregated_scores": aggregated,
    }


def render_ascii(result: T.Dict[str, T.Any], key: str = "ac") -> str:
    lines = []
    models = result["models"]
    header = f"{'Action':<25}" + "".join(f" {m[:12]:>12}" for m in models)
    lines.append(header)
    lines.append("-" * len(header))
    for action in result["actions"]:
        row = f"{action:<25}"
        for m in models:
            v = result["table_data"][action][m][key]
            row += f" {v:>12.2f}" if v is not None else f" {'N/A':>12}"
        lines.append(row)
    return "\n".join(lines)


def main(argv: T.Optional[T.List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Build the TAG leaderboard table")
    p.add_argument("--scores", required=True, help="scores.json path")
    p.add_argument("--output", default="comparison_table.json")
    args = p.parse_args(argv)

    with open(args.scores) as f:
        scores = json.load(f)
    result = build_leaderboard(scores)
    with open(args.output, "w") as f:
        json.dump(result, f, indent=2)
    print(f"AC range: [{result['normalization_ranges']['ac']['min']:.4f}, "
          f"{result['normalization_ranges']['ac']['max']:.4f}]")
    print(render_ascii(result, "ac"))
    print()
    print(render_ascii(result, "tc"))
    print(f"Output saved to {args.output}")


if __name__ == "__main__":
    main()
