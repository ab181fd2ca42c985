"""The mesh-recovery modules of the port (ViTDet crop, ViT backbone, SMPL token
head) on the CPU against the JAX package, with the same numpy weights carried
across by ``models/torch_compat.py``. JAX runs at matmul precision "highest";
where a JAX branch reaches a Pallas kernel it runs in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.ops import upstream_crops as jax_crops
from video_gen_evals_tpu_torch.models.smpl_head import (
    SMPLHeadConfig,
    SMPLTokenDecoderHead,
    canonical_head_state_dict,
    classifier_config_from_state_dict,
)
from video_gen_evals_tpu_torch.models.torch_compat import (
    head_state_dict_from_jax_tree,
    vit_state_dict_from_jax_tree,
)
from video_gen_evals_tpu_torch.models.vit import ViTBackbone, ViTBlock, ViTConfig
from video_gen_evals_tpu_torch.ops.precision import set_precision_
from video_gen_evals_tpu_torch.ops.so3 import rot6d_to_rotmat
from video_gen_evals_tpu_torch.ops.upstream_crops import vitdet_mesh_crop

TINY_VIT = dict(img_size=(64, 48), patch_size=16, embed_dim=64, depth=2, num_heads=4)
TINY_HEAD = dict(dim=64, context_dim=64, depth=2, heads=4, dim_head=16, mlp_dim=64, token_num=16,
                 token_class_num=32, token_code_dim=8, dec_hidden_dim=8, dec_token_inter_dim=16,
                 dec_hidden_inter_dim=16)
# port attention_impl -> the JAX module's name for the same branch on the CPU
JAX_IMPL = {"plain": "xla", "core": "core_interpret", "head_batched": "head_batched_interpret",
            "flash": "pallas_interpret"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def highest():
    """JAX matmuls in fp32 for the test, the flag and the compiled
    executables put back after it."""
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", before)
    jax.clear_caches()


def numpy_tree(tree, rng):
    """A flax param tree's structure filled from numpy: kernels normal with
    std fan_in ** -0.5, scales 1 + 0.1 n, everything else 0.1 n (biases and
    the IEF buffers included, so nothing is tested at zero)."""
    def fill(path, leaf):
        name = path[-1].key
        n = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            n = n / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            n = 1.0 + 0.1 * n if name == "scale" else 0.1 * n
        return n.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def init_tree(jmod, example, rng):
    """The module's param tree, its shapes traced without running the
    initialisers, filled from numpy."""
    return numpy_tree(jax.eval_shape(jmod.init, jax.random.key(0), example)["params"], rng)


def apply(jmod, tree, x):
    return jax.jit(jmod.apply)({"params": tree}, jnp.asarray(x))


def assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


def _frames_and_boxes(seed, boxes):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(len(boxes), 120, 160, 3)).astype(np.float32)
    return frames, np.asarray(boxes, np.float32)


def _crop_both(frames, boxes, **kw):
    kw = dict(out_hw=(64, 48), mean=np.zeros(3, np.float32), std=np.ones(3, np.float32), **kw)
    # eager: under jit XLA's CPU code rounds the gaussian weights differently,
    # which moves blurred values by up to 3e-3 on the 0..255 scale
    want = np.asarray(jax_crops.vitdet_mesh_crop(jnp.asarray(frames), jnp.asarray(boxes), **kw))
    got = vitdet_mesh_crop(torch.from_numpy(frames), torch.from_numpy(boxes), **kw).numpy()
    return got, want


# boxes whose 2x window is 64 or 32 pixels with a quarter-pixel offset: the
# warp weights are multiples of 1/4 and the crop values multiples of 1/16,
# exact in both frameworks, so cv2's rounding of the unblurred path cannot
# fall on different sides
EXACT_BOXES = [(45.25, 24.5, 55.25, 56.5), (100.0, 60.25, 108.0, 76.25), (0.25, 90.0, 10.25, 122.0)]
# windows of 160 to 230 pixels: a downsampling factor above 1.1, so blurred
LARGE_BOXES = [(30.3, 10.2, 90.9, 95.7), (70.1, 20.0, 150.4, 118.3), (-20.0, 5.5, 60.2, 110.9)]


def test_vitdet_crop_matches_jax_with_and_without_blur(highest):
    """A batch that mixes blurred and unblurred frames: every value within
    1e-3 on the 0..255 scale (before normalising)."""
    frames, boxes = _frames_and_boxes(0, LARGE_BOXES + EXACT_BOXES)
    got, want = _crop_both(frames, boxes, rescale_factor=2.0)
    assert got.shape == (6, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # the unblurred frames went through the rounding branch, the others not
    assert np.array_equal(got[3:], np.round(got[3:]))
    assert not np.array_equal(got[:3], np.round(got[:3]))


def test_vitdet_crop_default_rescale_and_no_antialias(highest):
    frames, boxes = _frames_and_boxes(1, LARGE_BOXES)
    got, want = _crop_both(frames, boxes)                       # 2.5x: all blurred
    np.testing.assert_allclose(got, want, atol=1e-3)
    frames, boxes = _frames_and_boxes(2, EXACT_BOXES)
    got, want = _crop_both(frames, boxes, rescale_factor=2.0, antialias=False)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # normalised output: the default mean and std
    a = vitdet_mesh_crop(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw=(64, 48))
    b = jax_crops.vitdet_mesh_crop(jnp.asarray(frames), jnp.asarray(boxes), out_hw=(64, 48))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    with pytest.raises(ValueError, match="even"):
        vitdet_mesh_crop(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw=(64, 47))


def _vit_pair(impl, rng):
    jcfg = jax_vit.ViTConfig(**TINY_VIT, attention_impl=JAX_IMPL[impl])
    jmod = jax_vit.ViTBackbone(jcfg)
    tree = init_tree(jmod, jnp.zeros((1, 64, 48, 3)), rng)
    cfg = ViTConfig(**TINY_VIT, attention_impl=impl)
    port = ViTBackbone(cfg).eval()
    port.load_state_dict(vit_state_dict_from_jax_tree(tree, cfg))
    return jmod, tree, port, jcfg


@pytest.mark.parametrize("impl", ["plain", "core", "head_batched", "flash"])
def test_vit_backbone_matches_jax(highest, impl):
    """Tokens and feature map within 2e-4 (fp32, two blocks and three
    LayerNorms deep) for every attention_impl against the same JAX branch."""
    rng = np.random.default_rng(3)
    jmod, tree, port, _ = _vit_pair(impl, rng)
    x = rng.normal(size=(3, 64, 48, 3)).astype(np.float32)
    want_tokens, want_fmap = apply(jmod, tree, x)
    with torch.inference_mode():
        tokens, fmap = port(torch.from_numpy(x))
    assert tokens.shape == (3, 12, 64) and fmap.shape == (3, 64, 4, 3)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), atol=2e-4)
    np.testing.assert_allclose(fmap.numpy(), np.asarray(want_fmap), atol=2e-4)


def test_vit_flash_bf16_impl_and_bf16_activations():
    """"flash_bf16" rounds q, k, v and p to bf16: within 0.05 of "plain" on
    the same weights, and not equal to it. A block with bf16-rounded weights
    at the "default" class runs every impl on fp32 activations."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 12, 64)).astype(np.float32))
    blocks = {impl: ViTBlock(64, 4, attention_impl=impl).eval()
              for impl in ("plain", "flash_bf16", "core", "head_batched", "flash")}
    for blk in blocks.values():
        blk.load_state_dict(blocks["plain"].state_dict())
    with torch.inference_mode():
        want = blocks["plain"](x)
        got = blocks["flash_bf16"](x)
        assert (got - want).abs().max().item() <= 0.05
        assert not torch.equal(got, want)
        for impl in ("core", "head_batched", "flash"):
            out = set_precision_(blocks[impl].to(torch.bfloat16), "default")(x)
            assert out.dtype == torch.float32
            assert (out - want).abs().max().item() <= 0.1, impl
    with pytest.raises(ValueError, match="attention_impl"):
        ViTConfig(attention_impl="xla")


def test_vit_state_dict_round_trip_and_cls_token(highest):
    """``torch_vit_to_flax`` of the port's state_dict is the JAX tree it came
    from; the names are the published checkpoint's; the class-token variant
    matches too."""
    rng = np.random.default_rng(5)
    _jmod, tree, port, jcfg = _vit_pair("plain", rng)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {"patch_embed.proj.weight", "pos_embed", "blocks.1.attn.qkv.bias",
            "blocks.0.mlp.fc2.weight", "norm.weight"} <= set(sd)
    assert sd["patch_embed.proj.weight"].shape == (64, 3, 16, 16)
    assert_trees_equal(jax_vit.torch_vit_to_flax(sd, jcfg), tree)

    kw = dict(TINY_VIT, use_cls_token=True, depth=1)
    jmod = jax_vit.ViTBackbone(jax_vit.ViTConfig(**kw))
    tree = init_tree(jmod, jnp.zeros((1, 64, 48, 3)), rng)
    cfg = ViTConfig(**kw, attention_impl="plain")
    port = ViTBackbone(cfg).eval()
    port.load_state_dict(vit_state_dict_from_jax_tree(tree, cfg))
    x = rng.normal(size=(2, 64, 48, 3)).astype(np.float32)
    want, _ = apply(jmod, tree, x)
    with torch.inference_mode():
        got, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def _head_pair(ief_iters, rng):
    jcfg = jax_head.SMPLHeadConfig(**TINY_HEAD, ief_iters=ief_iters)
    jmod = jax_head.SMPLTokenDecoderHead(jcfg)
    tree = init_tree(jmod, jnp.zeros((1, 12, 64)), rng)
    cfg = SMPLHeadConfig(**TINY_HEAD, ief_iters=ief_iters)
    port = SMPLTokenDecoderHead(cfg).eval()
    port.load_state_dict(head_state_dict_from_jax_tree(tree, cfg))
    return jmod, jcfg, tree, port, cfg


@pytest.mark.parametrize("ief_iters", [1, 2])
def test_smpl_head_matches_jax(highest, ief_iters):
    """Every output of the head within 1e-4 (fp32; the rotations come out of
    a normalisation, the rest out of linear readouts)."""
    rng = np.random.default_rng(6)
    jmod, _jcfg, tree, port, _cfg = _head_pair(ief_iters, rng)
    ctx = rng.normal(size=(3, 12, 64)).astype(np.float32)
    want = apply(jmod, tree, ctx)
    with torch.inference_mode():
        got = port(torch.from_numpy(ctx))
    assert set(got) == set(want) == {"global_orient", "body_pose", "betas", "cam", "token_out"}
    assert got["body_pose"].shape == (3, 23, 3, 3) and got["global_orient"].shape == (3, 1, 3, 3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    R = got["body_pose"]
    eye = torch.eye(3).expand_as(R)
    assert (R @ R.transpose(-1, -2) - eye).abs().max().item() <= 1e-5
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)


def test_head_state_dict_round_trip_and_upstream_prefixes(highest):
    """``torch_head_to_flax`` of the port's state_dict is the JAX tree; a
    checkpoint that nests the tokenizer decoder under a prefix and names the
    classifier differently loads after ``canonical_head_state_dict``; its
    geometry is read from the shapes; an unknown key fails loudly."""
    rng = np.random.default_rng(7)
    _jmod, jcfg, tree, port, cfg = _head_pair(1, rng)
    sd = port.state_dict()
    assert {"transformer.transformer.layers.1.1.fn.to_kv.weight", "transformer.pos_embedding",
            "transformer.transformer.layers.0.2.fn.net.3.bias", "decpose.decoder.0.MLP_token.ff.3.weight",
            "decpose_grot.weight", "init_body_pose"} <= set(sd)
    assert_trees_equal(jax_head.torch_head_to_flax({k: v.numpy() for k, v in sd.items()}, jcfg), tree)

    def upstream(key):
        if not key.startswith("decpose."):
            return key
        rest = key[len("decpose."):]
        return "decpose.cls.fc." + rest[len("cls_head."):] if rest.startswith("cls_head.") \
            else "decpose.tokenizer." + rest
    nested = {upstream(k): v for k, v in sd.items()}
    assert "decpose.tokenizer.decoder.0.layernorm1.weight" in nested
    canon = canonical_head_state_dict(nested)
    assert set(canon) == set(sd)
    fresh = SMPLTokenDecoderHead(classifier_config_from_state_dict(nested, SMPLHeadConfig(
        **dict(TINY_HEAD, token_num=4, token_class_num=5, token_code_dim=6, dec_hidden_dim=7))))
    assert dataclasses.asdict(fresh.config) == dataclasses.asdict(cfg)
    fresh.load_state_dict(canon)
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in sd.items())

    extra = dict(nested, **{"decpose.tokenizer.unknown_block.weight": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="unknown_block"):
        SMPLTokenDecoderHead(cfg).load_state_dict(canonical_head_state_dict(extra))


def test_rot6d_matches_jax():
    from video_gen_evals_tpu.ops.so3 import rot6d_to_rotmat as jax_rot6d

    x = np.random.default_rng(8).normal(size=(5, 24, 6)).astype(np.float32)
    np.testing.assert_allclose(rot6d_to_rotmat(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_rot6d(jnp.asarray(x))), atol=1e-6)
