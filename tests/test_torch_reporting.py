"""The port's reporting slice against the JAX package, exactly: the
leaderboard (C30) and the human-MOS pipeline (C31) on
``tests/test_reporting.py``'s fixtures and the shipped MOS file, their CLIs'
output files byte for byte; ``merge_scores`` (conflicts, incomplete shard
sets, ``--allow-partial``, the merged correlations) and ``shard_items``
over a grid of sizes and host counts. Nothing here spawns a process."""

import json
import os

import numpy as np
import pytest

from video_gen_evals_tpu.human import mos as jax_mos
from video_gen_evals_tpu.parallel import shard_items as jax_shard_items
from video_gen_evals_tpu.pipelines import leaderboard as jax_leaderboard
from video_gen_evals_tpu.pipelines import merge_scores as jax_merge

from video_gen_evals_tpu_torch.human import mos
from video_gen_evals_tpu_torch.parallel import shard_items
from video_gen_evals_tpu_torch.pipelines import leaderboard, merge_scores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shipped benchmark MOS file, read where it is (a data file, not an import)
SHIPPED_MOS = os.path.join(REPO, "video_gen_evals_tpu", "human", "fixtures", "TAG_final_human_scores.json")
NAMES = [
    "Hunyuan_BodyWeightSquats_01_08d40ea1.mp4",
    "Opensora_768_BodyWeightSquats_01_73f1e099.mp4",
    "wan21_TennisSwing_77.mp4",
    "Wan2.2_JumpingJack_3_12.mp4",
    "RunwayGen4_12_PushUps.mp4",
    "no_action_here.mp4",
    "Model_CamelCase_7.mp4",
    "_Lead_PullUps_0.mp4",
]


def _shipped():
    with open(SHIPPED_MOS) as f:
        return json.load(f)


def _make_rows(rng, n_participants=8, n_videos=20, bad_pids=()):
    """tests/test_reporting.py's synthetic ratings: shared per-video quality
    + rater noise; participants in bad_pids rate at random."""
    true_ac = rng.uniform(1, 5, size=n_videos)
    true_tc = rng.uniform(1, 5, size=n_videos)
    rows = []
    for p in range(n_participants):
        pid = f"p{p}"
        noisy = pid in bad_pids
        for v in range(n_videos):
            for _ in range(2 if v < 3 else 1):
                ac = rng.uniform(1, 5) if noisy else true_ac[v] + rng.normal(0, 0.3)
                tc = rng.uniform(1, 5) if noisy else true_tc[v] + rng.normal(0, 0.3)
                rows.append({"participant_id": pid, "video_id": f"gen_videos_vid{v:02d}",
                             mos.AC_KEY: float(ac), mos.TC_KEY: float(tc)})
    participants = {}
    for r in rows:
        participants.setdefault(r["participant_id"], []).append(r)
    return rows, participants


def test_leaderboard_functions_equal_jax():
    """``parse_filename`` (the trailing-digit quirk and the CamelCase
    fallback), ``normalize_to_0_100``, ``build_leaderboard`` and
    ``render_ascii`` equal JAX's, on tests/test_reporting.py's scores and on
    the shipped MOS file read as a score set."""
    for name in NAMES + list(_shipped()):
        assert leaderboard.parse_filename(name) == jax_leaderboard.parse_filename(name), name
    for args in ((5, 0, 10), (3, 3, 3), (0, 0, 10), (-1.5, -2.0, 4.0)):
        assert leaderboard.normalize_to_0_100(*args) == jax_leaderboard.normalize_to_0_100(*args)
    small = {"Hunyuan_JumpingJack_01_a.mp4": {"ac": 0.2, "tc": 0.1},
             "Hunyuan_PushUps_02_b.mp4": {"ac": 0.6, "tc": 0.3},
             "wan21_JumpingJack_03_c.mp4": {"ac": 0.8, "tc": 0.5}}
    for scores in (small, _shipped()):
        got, want = leaderboard.build_leaderboard(scores), jax_leaderboard.build_leaderboard(scores)
        assert json.dumps(got) == json.dumps(want)
        for key in ("ac", "tc", "avg"):
            assert leaderboard.render_ascii(got, key) == jax_leaderboard.render_ascii(want, key)
    with pytest.raises(ValueError, match="no parseable"):
        leaderboard.build_leaderboard({"x.mp4": {"ac": 1.0, "tc": 1.0}})


@pytest.mark.parametrize("seed", [1337, 7])
def test_mos_stages_equal_jax(seed):
    """Each filtering stage, the z-scored MOS and the name normalization
    give JAX's result exactly."""
    rows, participants = _make_rows(np.random.default_rng(seed), n_participants=12, bad_pids=("p0", "p7"))
    s1 = mos.stage1_repeated_video_consistency(participants)
    assert s1 == jax_mos.stage1_repeated_video_consistency(participants)
    for key in (mos.AC_KEY, mos.TC_KEY):
        s2 = mos.stage2_subject_rejection(s1, key)
        assert s2 == jax_mos.stage2_subject_rejection(s1, key)
        s3 = mos.stage3_inter_rater_reliability(s2, key)
        assert s3 == jax_mos.stage3_inter_rater_reliability(s2, key)
        assert mos.compute_mos_and_normalize(s3, key) == jax_mos.compute_mos_and_normalize(s3, key)
    for vid in ("gen_videos_vid01", "a/b/GenModel_JumpingJack_01.mp4", "x.MP4"):
        assert mos.normalize_video_id(vid) == jax_mos.normalize_video_id(vid)


def test_reporting_clis_write_jax_bytes(tmp_path, capsys):
    """The MOS CLI on JSON and CSV ratings and the leaderboard CLI on its
    output and on the shipped MOS file write the bytes JAX's CLIs write,
    and print the same."""
    rows, _ = _make_rows(np.random.default_rng(3), n_participants=8, bad_pids=("p7",))
    raw_json = str(tmp_path / "raw.json")
    with open(raw_json, "w") as f:
        json.dump(rows, f)
    raw_csv = str(tmp_path / "raw.csv")
    with open(raw_csv, "w") as f:
        f.write(f"participant_id,video_id,{mos.AC_KEY},{mos.TC_KEY}\n")
        for r in rows:
            f.write(f"{r['participant_id']},{r['video_id']},{r[mos.AC_KEY]!r},{r[mos.TC_KEY]!r}\n")

    def both(port_main, jax_main, argv_of):
        outs = []
        for tag, fn in (("port", port_main), ("jax", jax_main)):
            path = str(tmp_path / f"{tag}.json")
            fn(argv_of(path))
            with open(path, "rb") as f:
                outs.append((f.read(), capsys.readouterr().out.replace(path, "OUT")))
        assert outs[0] == outs[1]
        return outs[0][0]

    for raw in (raw_json, raw_csv):
        written = both(mos.main, jax_mos.main, lambda out: ["--input", raw, "--output", out])
        assert len(json.loads(written)) == 20
    human = str(tmp_path / "human.json")
    mos.main(["--input", raw_json, "--output", human])
    capsys.readouterr()
    with open(human) as f:
        scores = {f"Model{i % 3}_{'JumpingJack' if i % 2 else 'PushUps'}_{i:02d}.mp4": v
                  for i, v in enumerate(json.load(f).values())}
    scores_path = str(tmp_path / "scores.json")
    with open(scores_path, "w") as f:
        json.dump(scores, f)
    for path in (scores_path, SHIPPED_MOS):
        both(leaderboard.main, jax_leaderboard.main, lambda out: ["--scores", path, "--output", out])


def test_shard_items_equals_jax():
    """Every (size, host count, host id) of a grid gives JAX's shard; the
    shards partition the list; bad host arguments raise JAX's errors."""
    for size in range(0, 13):
        items = [f"v{i:02d}" for i in range(size)]
        for num_hosts in range(1, 6):
            parts = [shard_items(items, h, num_hosts) for h in range(num_hosts)]
            assert parts == [jax_shard_items(items, h, num_hosts) for h in range(num_hosts)]
            assert sorted(sum(parts, [])) == items
    for host_id, num_hosts, match in ((0, 0, "num_hosts must be"), (2, 2, "host_id must be"),
                                      (-1, 2, "host_id must be")):
        for fn in (shard_items, jax_shard_items):
            with pytest.raises(ValueError, match=match):
                fn([1, 2, 3], host_id, num_hosts)


def test_merge_score_shards_equal_jax():
    """Union, tolerated re-runs (within SCORE_ATOL / SCORE_RTOL, NaN against
    NaN), conflicts raised with JAX's message, and the coverage check on
    complete, missing, duplicate, mixed-N and unsuffixed shard sets."""
    assert (merge_scores.SCORE_ATOL, merge_scores.SCORE_RTOL) == (jax_merge.SCORE_ATOL, jax_merge.SCORE_RTOL)
    a = {"v1": {"ac": 0.5, "tc": 0.25}, "v2": {"tc": float("nan")}}
    b = {"v3": {"ac": 1.0, "tc": 2.0}, "v1": {"ac": 0.5 + 5e-5, "tc": 0.25}, "v2": {"tc": float("nan")}}
    got, want = merge_scores.merge_score_shards([a, b]), jax_merge.merge_score_shards([a, b])
    assert json.dumps(got) == json.dumps(want)
    for bad in ({"v1": {"ac": 0.6, "tc": 0.25}}, {"v1": {"tc": 0.25}}):
        with pytest.raises(ValueError) as port_err:
            merge_scores.merge_score_shards([a, bad])
        with pytest.raises(ValueError) as jax_err:
            jax_merge.merge_score_shards([a, bad])
        assert str(port_err.value) == str(jax_err.value)
    for paths in (["s.host0of2.json", "s.host1of2.json"], ["s.host0of3.json", "s.host2of3.json"],
                  ["s.host0of2.json", "s.host0of2.json"], ["s.host0of2.json", "s.host1of3.json"],
                  ["a.json", "s.host0of2.json"], ["s.host1of2.txt"], []):
        assert merge_scores.check_shard_coverage(paths) == jax_merge.check_shard_coverage(paths), paths


def test_merge_scores_cli_equals_jax(tmp_path, capsys):
    """The merge CLI against JAX's: the merged file byte for byte and the
    same correlations printed; an incomplete shard set refused by both, and
    merged by both under --allow-partial."""
    rng = np.random.default_rng(5)
    names = [f"GenModel{i % 2}_{'JumpingJack' if i % 3 else 'PushUps'}_{i:02d}" for i in range(9)]
    human = str(tmp_path / "human.json")
    with open(human, "w") as f:
        json.dump({f"{n}.mp4": {"ac": float(rng.normal()), "tc": float(rng.normal())} for n in names}, f)
    shards = []
    for h in range(3):
        path = str(tmp_path / f"scores.host{h}of3.json")
        with open(path, "w") as f:
            json.dump({n: {"ac": float(rng.normal()), "tc": float(rng.normal())} for n in names[h::3]}, f)
        shards.append(path)
    outs = {}
    for tag, fn in (("port", merge_scores.main), ("jax", jax_merge.main)):
        out = str(tmp_path / f"{tag}.json")
        fn(shards + ["--output", out, "--human-scores", human])
        with open(out, "rb") as f:
            outs[tag] = (f.read(), capsys.readouterr().out.replace(out, "OUT"))
        with pytest.raises(SystemExit):
            fn(shards[:2] + ["--output", out])
        assert "missing host shards [2]" in capsys.readouterr().err
        fn(shards[:2] + ["--output", out, "--allow-partial"])
        with open(out) as f:
            assert len(json.load(f)) == 6
        capsys.readouterr()
    assert outs["port"] == outs["jax"]
    assert "ac_corr: spearman=" in outs["port"][1] and "(n=9)" in outs["port"][1]
