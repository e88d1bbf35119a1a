"""The PyTorch port stands alone: every module imports with ``jax``,
``orbax`` and ``tensorstore`` blocked, no file of the port (or
chip_smoke.py) imports jax, orbax, tensorstore or megatron_llm_tpu,
entry points default to the GPU, and chip_smoke.py refuses to run
without a CUDA device or outside a checkout."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

from megatron_llm_torch import finetune
from megatron_llm_torch.arguments import build_parser as build_train_parser
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.tree import tree_map
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.run_text_generation_server import build_parser
from megatron_llm_torch.text_generation.generation import init_paged_kv_caches
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "megatron_llm_torch")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    return [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
            .removesuffix(".__init__") for p in _port_files()]


def test_every_port_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['megatron_llm_tpu'] = None\n"
            "sys.modules['orbax'] = None\n"
            "sys.modules['tensorstore'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "megatron_llm_tpu", "orbax", "tensorstore")
    for path in _port_files() + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_entry_points_default_to_the_gpu():
    model = LlamaModel(llama_config("tiny"))
    assert model.device.type == "cuda"
    args = build_parser().parse_args(["--model_name", "llama2"])
    assert args.device == "cuda"
    for fn in (init_paged_kv_caches, params_from_jax,
               finetune.build_data_iterator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert build_train_parser().parse_args([]).device == "cuda"
    # the train step and the optimizer allocate where the params live
    # (a default model's: the card)
    cpu_params = LlamaModel(llama_config("tiny"), device="cpu").init(0)
    state = MegatronOptimizer(TrainConfig()).init(cpu_params)
    assert state.exp_avg["lm_head"]["weight"].device.type == "cpu"
    if not torch.cuda.is_available():
        tiny = ["--model_name=llama2", "--num_layers=1", "--hidden_size=64",
                "--num_attention_heads=4", "--seq_length=8",
                "--vocab_size=128", "--train_iters=1"]
        with pytest.raises((AssertionError, RuntimeError)):
            finetune.main(tiny)
        # with no card, the defaults reach for one and fail loudly
        cfg = llama_config("tiny")
        with pytest.raises((AssertionError, RuntimeError)):
            init_paged_kv_caches(cfg, 2, 4)
        tree = tree_map(lambda t: t.numpy(),
                        LlamaModel(cfg, device="cpu").init(0))
        with pytest.raises((AssertionError, RuntimeError)):
            params_from_jax(tree, cfg)


def _smoke(cwd):
    res = subprocess.run([sys.executable, os.path.join(cwd, "chip_smoke.py")],
                         cwd=cwd, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               CUDA_VISIBLE_DEVICES=""))
    return res


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    res = _smoke(REPO)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    res = _smoke(str(tmp_path))
    assert res.returncode != 0 and '"ok"' not in res.stdout
