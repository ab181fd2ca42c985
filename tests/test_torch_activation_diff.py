"""The port's activation-diff harness (``pipelines/activation_diff.py``) on
the CPU at tiny geometry, against the same in-repo torch replicas as
``tests/test_activation_diff.py`` (the JAX harness): every anchor ``ok``
within 1e-4 for the five networks, the same anchors, order, statuses and
shapes as ``scripts/activation_diff.py::run_diff`` on the same state_dict,
input and activations (the port compares in NCHW, JAX in NHWC), a corrupted
layer localized, the CLI's exit codes and the import without JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_activation_diff import _TimmViT
from test_activation_diff import run_diff as jax_run_diff
from video_gen_evals_tpu_torch.models.rcnn import RCNNConfig
from video_gen_evals_tpu_torch.pipelines import activation_diff as ad

TOL = 1e-4
VIT = dict(img_size=[32, 24], patch_size=8, embed_dim=32, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vit():
    torch.manual_seed(0)
    x = np.random.default_rng(0).normal(size=(2, 32, 24, 3)).astype(np.float32)
    return _TimmViT().eval(), x, VIT, VIT


def _smpl_head():
    from test_tokenhmr_decoder import TorchSMPLTokenHead, _classifier_cfg

    cfg = _classifier_cfg()
    torch.manual_seed(7)
    x = np.random.default_rng(7).normal(size=(2, 6, cfg.context_dim)).astype(np.float32)
    return TorchSMPLTokenHead(cfg).eval(), x, dataclasses.asdict(cfg), dataclasses.asdict(cfg)


def _rtmpose():
    from test_rtmpose import TINY, TorchRTMPose, _randomize_bn_stats

    torch.manual_seed(3)
    ref = TorchRTMPose(TINY).eval()
    with torch.no_grad():
        _randomize_bn_stats(ref, np.random.default_rng(3))
    x = np.random.default_rng(3).normal(size=(2, *TINY.input_hw, 3)).astype(np.float32)
    return ref, x, dataclasses.asdict(TINY), dataclasses.asdict(TINY)


def _yolox():
    from test_yolox import TINY, TorchYOLOX, _randomize_bn_stats

    torch.manual_seed(4)
    ref = TorchYOLOX(TINY).eval()
    with torch.no_grad():
        _randomize_bn_stats(ref, np.random.default_rng(4))
    x = np.random.default_rng(4).normal(size=(1, *TINY.input_hw, 3)).astype(np.float32)
    return ref, x, dataclasses.asdict(TINY), dataclasses.asdict(TINY)


def _rcnn():
    from test_rcnn import TorchRCNN, _randomize
    from video_gen_evals_tpu.models.rcnn import RCNNConfig as JaxRCNNConfig

    jcfg = JaxRCNNConfig.small()
    ref = _randomize(TorchRCNN(jcfg), seed=6).eval()
    x = np.random.default_rng(6).normal(size=(1, 64, 96, 3)).astype(np.float32)
    return ref, x, dataclasses.asdict(jcfg), dataclasses.asdict(RCNNConfig.small())


# network -> (replica, input, JAX overrides, port overrides), and the anchor count
NETS = {"vit": (_vit, 4), "smpl_head": (_smpl_head, 3 * 2 + 1 + 6 + 2 + 4),
        "rtmpose": (_rtmpose, 10), "yolox": (_yolox, 1 + 4 + 8 + 18), "rcnn": (_rcnn, 1 + 4 + 8 + 2)}


def _reference(network):
    ref, x, jax_over, port_over = NETS[network][0]()
    acts = ad.torch_module_activations(ref, torch.from_numpy(x if x.ndim == 3 else x.transpose(0, 3, 1, 2)))
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    return sd, x, acts, jax_over, port_over


@pytest.mark.parametrize("network", sorted(NETS))
def test_network_matches_jax_harness(network):
    """Every anchor ``ok`` within 1e-4 of the replica, and the rows those of
    the JAX harness on the same state_dict, input and activations: anchor by
    anchor, in order, with the same status and the same shape up to the
    NHWC layout of JAX's 4-d rows."""
    sd, x, acts, jax_over, port_over = _reference(network)
    rows = ad.run_diff(network, sd, x, acts, port_over, device="cpu")
    assert len(rows) == NETS[network][1]
    bad = [(r.torch_name, r.status, r.max_abs) for r in rows if r.status != "ok" or not r.max_abs <= TOL]
    assert not bad, bad
    want = jax_run_diff(network, sd, x, acts, jax_over)
    assert [r.torch_name for r in rows] == [r.torch_name for r in want]
    assert [r.status for r in rows] == [r.status for r in want]
    for r, w in zip(rows, want):
        s = w.shape if len(w.shape) != 4 else (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        assert r.shape == s, (r.torch_name, r.shape, w.shape)
        assert r.max_ref > 0


def test_vit_corruption_is_localized():
    """A perturbed ``blocks.1.mlp.fc1.weight`` leaves ``blocks.0`` within 1e-4
    and puts ``blocks.1`` above 1e-2 (a random perturbation: a constant one
    would vanish on fc1's zero-mean LayerNorm input)."""
    ref, _, _, over = _vit()
    x = np.random.default_rng(0).normal(size=(1, 32, 24, 3)).astype(np.float32)
    acts = ad.torch_module_activations(ref, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    w = sd["blocks.1.mlp.fc1.weight"]
    sd["blocks.1.mlp.fc1.weight"] = w + np.random.default_rng(0).normal(scale=0.1, size=w.shape).astype(np.float32)
    by_name = {r.torch_name: r for r in ad.run_diff("vit", sd, x, acts, over, device="cpu")}
    assert by_name["blocks.0"].max_abs <= TOL
    assert by_name["blocks.1"].max_abs > 1e-2


@pytest.fixture(scope="module")
def vit_files(tmp_path_factory):
    """The ViT replica's state_dict as a TokenHMR-style ``.ckpt`` (under
    ``state_dict``, keys ``model.backbone.*``), its input and activations."""
    tmp = tmp_path_factory.mktemp("vit")
    ref, x, _, _ = _vit()
    acts = ad.torch_module_activations(ref, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    torch.save({"state_dict": {f"model.backbone.{k}": v for k, v in ref.state_dict().items()}},
               tmp / "tokenhmr.ckpt")
    np.save(tmp / "x.npy", x)
    np.savez(tmp / "acts.npz", **acts)
    partial = {k: v for k, v in acts.items() if k != "blocks.1"}
    np.savez(tmp / "partial.npz", **partial)
    return tmp


def _cli(tmp, *extra, acts="acts.npz", prefix="model.backbone."):
    return ad.main(["--network", "vit", "--state-dict", str(tmp / "tokenhmr.ckpt"), "--key-prefix", prefix,
                    "--input", str(tmp / "x.npy"), "--acts", str(tmp / acts), "--device", "cpu",
                    "--config-json", '{"img_size": [32, 24], "patch_size": 8, "embed_dim": 32, '
                                     '"depth": 2, "num_heads": 4}', *extra])


@pytest.mark.parametrize("case,rc", [("clean", 0), ("over_tol", 1), ("missing_torch", 1),
                                     ("missing_torch_allowed", 0), ("stripped_prefix", 0)])
def test_cli_exit_codes(vit_files, capsys, case, rc):
    """The JAX script's exit codes: 0 clean, 1 over ``--tol``, 1 for an
    anchor missing from the dump unless ``--allow-missing-torch``; a
    ``--key-prefix`` written with or without the stripped ``model.``
    wrapper loads the same keys."""
    args = {"clean": (), "over_tol": ("--tol", "0"), "missing_torch": (),
            "missing_torch_allowed": ("--allow-missing-torch",), "stripped_prefix": ()}[case]
    kw = {"acts": "partial.npz"} if case.startswith("missing_torch") else {}
    if case == "stripped_prefix":
        kw["prefix"] = "backbone."
    assert _cli(vit_files, *args, **kw) == rc
    out = capsys.readouterr().out
    assert "layers compared" in out and ("[missing-torch]" in out) == case.startswith("missing_torch")


def test_device_defaults_to_the_card(vit_files):
    """Without ``--device`` the harness runs on the card, and raises on a
    machine without one; an unknown config field is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ad.main(["--network", "vit", "--state-dict", str(vit_files / "tokenhmr.ckpt"),
                 "--input", str(vit_files / "x.npy"), "--acts", str(vit_files / "acts.npz")])
    with pytest.raises(ValueError, match="unknown config field 'dim'"):
        ad.run_diff("vit", {}, np.zeros((1, 32, 24, 3), np.float32), {}, {"dim": 3}, device="cpu")


def test_suffix_tolerant_lookup_and_statuses():
    t = {"model.backbone.stem": np.zeros((1, 2)), "other": np.zeros((1,)), "b": np.zeros((1, 3))}
    p = {"backbone.stem": np.zeros((1, 2)), "b": np.zeros((1, 4))}
    rows = ad.diff_activations(t, p, [("backbone.stem", "backbone.stem"),   # matches by suffix
                                      ("missing.mod", "backbone.stem"),
                                      ("backbone.stem", "not.there"),
                                      ("b", "b")])
    assert [r.status for r in rows] == ["ok", "missing-torch", "missing-port", "shape"]
    assert rows[0].max_abs == 0.0


def test_load_state_dict_prefix_survives_wrapper_strip(tmp_path):
    """The loader strips ``model.`` / ``module.`` wrapper prefixes; a
    ``--key-prefix`` written against the raw keys still resolves, and a
    wrong prefix fails loudly."""
    p = str(tmp_path / "sd.pt")
    torch.save({"model.backbone.w": torch.ones(2, 2), "model.head.w": torch.zeros(3)}, p)
    assert sorted(ad._load_state_dict(p, key_prefix="model.backbone.")) == ["w"]
    assert sorted(ad._load_state_dict(p, key_prefix="backbone.")) == ["w"]
    with pytest.raises(ValueError, match="no keys under prefix"):
        ad._load_state_dict(p, key_prefix="model.nonexistent.")


def test_imports_without_jax():
    """The module imports, and its CLI's help runs, with ``jax`` and
    ``video_gen_evals_tpu`` unimportable."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'video_gen_evals_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from video_gen_evals_tpu_torch.pipelines import activation_diff as ad\n"
            "assert sorted(ad.NETWORKS) == ['rcnn', 'rtmpose', 'smpl_head', 'vit', 'yolox']\n"
            "try:\n"
            "    ad.main(['--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'video_gen_evals_tpu.'))\n"
            "               for m, v in sys.modules.items() if v is not None)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--network" in res.stdout
