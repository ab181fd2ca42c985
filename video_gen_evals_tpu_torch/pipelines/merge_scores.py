"""Merge per-host ``video_scores`` shards of a multi-host scoring sweep.

Copy of ``video_gen_evals_tpu/pipelines/merge_scores.py``. The per-host
shards come from ``pipelines.score --num-hosts N --host-id I`` (each host
scores a disjoint strided slice of the generated manifest, see
``parallel.shard_items``); this CLI reassembles the single
``video_scores.json`` the reference's ``eval.py`` writes (ref
``eval.py:439-453``) and, given ``--human-scores``, computes the final
sign-inverted Spearman/Pearson (ref ``eval.py:456-464``). Correlations need
every video, so they run here rather than per shard.

Shard filenames carry a ``.host<I>of<N>.json`` suffix (written by the score
CLI); when every input matches that pattern the merge verifies the set is
COMPLETE (one consistent N, every index 0..N-1 present) before computing
final numbers: a missing shard would otherwise silently publish
correlations over a fraction of the videos. ``--allow-partial`` skips the
check for deliberate partial merges.

    python -m video_gen_evals_tpu_torch.pipelines.merge_scores scores.host*of2.json \\
        --output video_scores.json [--human-scores MOS.json]
"""

from __future__ import annotations

import json
import math
import re
import sys
import typing as T

# module-top relative import: direct-file execution (`python .../merge_scores.py`)
# fails HERE, before any output is written, instead of half-succeeding after
# the merge — run as `python -m video_gen_evals_tpu_torch.pipelines.merge_scores`
from ..metrics.correlation import match_and_correlate

# per-video AC/TC may differ in the last float digits between runs of
# different batch composition (padding/reduction order); overlaps within
# this tolerance are idempotent re-runs, beyond it is real manifest drift.
# 1e-4 sits well under score scale (O(0.1-10)) and above bf16_3x noise.
SCORE_ATOL = 1e-4
SCORE_RTOL = 1e-4

# extension-agnostic: score.py preserves the --output extension when tagging
# shards (scores.host0of4.txt etc.), and the completeness check must not be
# silently skipped for them
_HOST_RE = re.compile(r"\.host(\d+)of(\d+)\.[^./\\]+$")


def merge_score_shards(
    shards: T.Sequence[T.Dict[str, T.Dict[str, float]]],
) -> T.Dict[str, T.Dict[str, float]]:
    """Union of per-host ``{vid: {ac, tc}}`` dicts.

    A video appearing in more than one shard with matching scores (within
    ``SCORE_ATOL``/``SCORE_RTOL`` — re-runs of different batch composition
    differ in the last float digits) is tolerated; a real conflict raises —
    that means two hosts scored the same video differently (manifest drift
    between hosts).
    """
    merged: T.Dict[str, T.Dict[str, float]] = {}
    for shard in shards:
        for vid, entry in shard.items():
            prev = merged.get(vid)
            if prev is not None and not _scores_close(prev, entry):
                raise ValueError(
                    f"conflicting scores for {vid!r} across shards: "
                    f"{prev} vs {entry} — hosts scanned different manifests?"
                )
            merged[vid] = entry
    return merged


def _scores_close(a: T.Dict[str, float], b: T.Dict[str, float]) -> bool:
    if set(a) != set(b):
        return False
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, float) or isinstance(vb, float):
            if math.isnan(va) and math.isnan(vb):
                continue  # identical NaN re-runs are idempotent, not a conflict
            if not math.isclose(va, vb, rel_tol=SCORE_RTOL, abs_tol=SCORE_ATOL):
                return False
        elif va != vb:
            return False
    return True


def check_shard_coverage(paths: T.Sequence[str]) -> T.Optional[str]:
    """If every path carries a ``.host<I>of<N>.json`` suffix, return an error
    string when the set is incomplete/inconsistent (else None). Mixed or
    unsuffixed names skip the check (caller merged hand-named files)."""
    parsed = [_HOST_RE.search(p) for p in paths]
    if not parsed or not all(parsed):
        return None
    ns = {int(m.group(2)) for m in parsed}
    if len(ns) != 1:
        return f"shards disagree on host count: {sorted(ns)}"
    n = ns.pop()
    ids = sorted(int(m.group(1)) for m in parsed)
    if ids != list(range(n)):
        missing = sorted(set(range(n)) - set(ids))
        dup = sorted({i for i in ids if ids.count(i) > 1})
        parts = []
        if missing:
            parts.append(f"missing host shards {missing}")
        if dup:
            parts.append(f"duplicate host shards {dup}")
        return f"incomplete {n}-host sweep: " + ", ".join(parts)
    return None


def main(argv: T.Optional[T.List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Merge per-host video_scores shards (multi-host sweep)"
    )
    p.add_argument("shards", nargs="+", help="per-host video_scores JSONs")
    p.add_argument("--output", default="video_scores.json")
    p.add_argument("--human-scores", default=None,
                   help="human MOS JSON — computes the final sign-inverted "
                        "Spearman on the merged set (ref eval.py:456-464)")
    p.add_argument("--allow-partial", action="store_true",
                   help="skip the hostIofN completeness check (deliberate "
                        "partial merge; correlations cover only the merged "
                        "subset)")
    args = p.parse_args(argv)

    if not args.allow_partial:
        err = check_shard_coverage(args.shards)
        if err:
            p.error(f"{err} — correlations need every video "
                    "(--allow-partial to merge anyway)")

    loaded = []
    for path in args.shards:
        with open(path) as f:
            loaded.append(json.load(f))
    merged = merge_score_shards(loaded)
    with open(args.output, "w") as f:
        json.dump(merged, f, indent=2)
    print(
        f"Merged {len(args.shards)} shards -> {len(merged)} videos "
        f"in {args.output}"
    )

    if args.human_scores:
        with open(args.human_scores) as f:
            human = json.load(f)
        ac_only = {k: v["ac"] for k, v in merged.items() if "ac" in v}
        tc_only = {k: v["tc"] for k, v in merged.items() if "tc" in v}
        failed = False
        for key, scores in (("ac_corr", ac_only), ("tc_corr", tc_only)):
            corr = match_and_correlate(scores, human, key.split("_")[0])
            if corr["spearman"] is None:
                if corr["n"] >= 2:
                    # enough matches but the correlation itself came back
                    # NaN: constant or non-finite scores (e.g. NaN AC from a
                    # class with zero train windows), not a name mismatch
                    print(
                        f"{key}: NOT computed — {corr['n']} videos matched "
                        "but the correlation is NaN; check for non-finite "
                        "or constant scores in the merged shards",
                        file=sys.stderr,
                    )
                else:
                    print(
                        f"{key}: NOT computed — only {corr['n']} merged "
                        "video(s) matched the human-score keys (need >= 2); "
                        "check name normalization between scores and MOS "
                        "JSON",
                        file=sys.stderr,
                    )
                failed = True
                continue
            pear = corr["pearson"]
            pear_s = f"{pear:.4f}" if pear is not None else "nan"
            print(
                f"{key}: spearman={corr['spearman']:.4f} pearson={pear_s} "
                f"p={corr['p_value']:.3g} (n={corr['n']})"
            )
        if failed:
            raise SystemExit(2)


if __name__ == "__main__":
    main()
