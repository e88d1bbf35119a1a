"""The port's Megatron ``mp_rank`` interop and checkpoint tool against the
JAX package's: synthesized reference checkpoints at tp 2 x pp 2 and
checkpoint versions 0, 1.0 and 3.0 (as tests/test_megatron_ckpt.py builds
them) import to the same params in both packages, export then import is
the identity, and ``tools/checkpoint_util`` casts dtypes, rewrites a
release checkpoint and bridges the megatron and port formats."""

import numpy as np
import pytest
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.tools import checkpoint_util
from megatron_llm_torch.weights_conversion import megatron_ckpt as port

from weights_conversion import megatron_ckpt as ref

torch.set_num_threads(2)
NH, HID = 4, 64


def _model():
    cfg = llama_config("tiny", num_layers=2, hidden_size=HID,
                       num_attention_heads=NH, ffn_hidden_size=96,
                       padded_vocab_size=128, seq_length=32,
                       max_position_embeddings=32)
    return cfg, LlamaModel(cfg, device="cpu")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        a = leaf.float().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf, np.float32)
        b = want[key].float().numpy() if isinstance(want[key], torch.Tensor) \
            else np.asarray(want[key], np.float32)
        np.testing.assert_array_equal(a, b, err_msg=str(key))


def _old_qkv_layout(w, version, nh_local):
    """A shard's v2 query_key_value rows [nh, 3, hd, ...] in the layout a
    v<2.0 build saved: [3, nh, hd, ...] (0) or [nh, hd, 3, ...] (1.0)."""
    hd = HID // NH
    x = w.reshape((nh_local, 3, hd) + w.shape[1:])
    if version == 0:
        old = np.swapaxes(x, 0, 1)
    else:
        old = np.moveaxis(x, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(old).reshape(w.shape))


def _tp2_pp2(tmp_path, params, cfg, version):
    """A tp 2 x pp 2 reference checkpoint at ``version``: a tp-2 export,
    each rank's layers filed into two stages with local indices."""
    flat = tmp_path / "flat"
    port.save_reference_checkpoint(str(flat), 1, params, cfg,
                                   tensor_parallel=2)
    out = tmp_path / f"v{version}"
    for rank in (0, 1):
        sd = torch.load(flat / "iter_0000001" / f"mp_rank_{rank:02d}"
                        / "model_optim_rng.pt", weights_only=False)
        lm = sd["model"]["language_model"]
        for stage in (0, 1):
            enc = {}
            for k, v in lm["encoder"].items():
                if k.startswith(f"layers.{stage}."):
                    k = k.replace(f"layers.{stage}.", "layers.0.")
                    if "query_key_value" in k and version < 2.0:
                        v = _old_qkv_layout(v.numpy(), version, NH // 2)
                    enc[k] = v
            stage_lm = {"encoder": enc}
            if stage == 0:
                stage_lm["embedding"] = lm["embedding"]
            else:
                stage_lm["lm_head"] = lm["lm_head"]
                enc["final_layernorm.weight"] = \
                    lm["encoder"]["final_layernorm.weight"]
            d = out / "iter_0000001" / f"mp_rank_{rank:02d}_{stage:03d}"
            d.mkdir(parents=True)
            torch.save({"model": {"language_model": stage_lm},
                        "checkpoint_version": version, "iteration": 1,
                        "args": sd["args"]}, d / "model_optim_rng.pt")
    (out / "latest_checkpointed_iteration.txt").write_text("1")
    return out


@pytest.mark.parametrize("version", [0, 1.0, 3.0])
def test_tp2_pp2_import_matches_the_jax_import(tmp_path, version):
    cfg, model = _model()
    params = model.init(0)
    ck = _tp2_pp2(tmp_path, params, cfg, version)
    got, config, meta = port.load_reference_checkpoint(str(ck))
    want, want_config, want_meta = ref.load_reference_checkpoint(str(ck))
    assert meta["checkpoint_version"] == want_meta["checkpoint_version"] \
        == float(version)
    assert config == want_config and config["num_layers"] == 2
    assert all(leaf.dtype == torch.float32 for leaf in _flat(got).values())
    _equal(got, want)
    _equal(got, params)


@pytest.mark.parametrize("tp", [1, 2])
def test_export_then_import_is_the_identity(tmp_path, tp):
    cfg, model = _model()
    params = model.init(1)
    port.save_reference_checkpoint(str(tmp_path / "p"), 7, params, cfg,
                                   tensor_parallel=tp)
    assert port.read_tracker(str(tmp_path / "p")) == "7"
    got, config, meta = port.load_reference_checkpoint(str(tmp_path / "p"))
    assert meta["checkpoint_version"] == 3.0
    assert not config["tie_embed_logits"]
    _equal(got, params)
    # the files the JAX exporter writes from the same params read the same
    ref.save_reference_checkpoint(
        str(tmp_path / "j"), 7,
        {k: v for k, v in _numpy_tree(params).items()}, cfg,
        tensor_parallel=tp)
    _equal(port.load_reference_checkpoint(str(tmp_path / "j"))[0], got)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _run_util(*argv):
    checkpoint_util.main([str(a) for a in argv])


def test_checkpoint_util_dtype_release_and_formats(tmp_path):
    cfg, model = _model()
    params = model.init(2)
    src = tmp_path / "src"
    checkpointing.save_checkpoint(str(src), 5, params,
                                  args=checkpointing.config_to_args(cfg))
    # a dtype cast with target sizes recorded, as a release checkpoint
    _run_util("--load_dir", src, "--save_dir", tmp_path / "bf16", "--dtype",
              "bf16", "--release", "--target_tensor_parallel_size", "2")
    assert (tmp_path / "bf16" / "latest_checkpointed_iteration.txt"
            ).read_text() == "release"
    got, _, meta = checkpointing.load_checkpoint(str(tmp_path / "bf16"),
                                                 device="cpu")
    assert meta["args"]["tensor_model_parallel_size"] == 2
    assert meta["args"]["num_layers"] == 2
    for key, leaf in _flat(got).items():
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf, _flat(params)[key].to(torch.bfloat16)), key
    # port -> megatron (tp 2) -> port, with identical weights
    _run_util("--load_dir", src, "--save_dir", tmp_path / "meg",
              "--output_format", "megatron",
              "--target_tensor_parallel_size", "2")
    assert sorted(p.name for p in (tmp_path / "meg" / "iter_0000005"
                                   ).iterdir()) == ["mp_rank_00",
                                                    "mp_rank_01"]
    _run_util("--load_dir", tmp_path / "meg", "--save_dir", tmp_path / "back",
              "--input_format", "megatron")
    back, _, meta = checkpointing.load_checkpoint(str(tmp_path / "back"),
                                                  device="cpu")
    assert meta["iteration"] == 5
    _equal(back, params)
    # the JAX tool's import of the same megatron checkpoint agrees
    _equal(back, ref.load_reference_checkpoint(str(tmp_path / "meg"))[0])
    assert "torch" in checkpoint_util.build_parser().format_help()
