"""The PyTorch port stands alone: every module imports with ``jax``
blocked, no file of the port (or chip_smoke.py) imports jax or
megatron_llm_tpu, entry points default to the GPU, and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.models.transformer import tree_map
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
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "megatron_llm_tpu")
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
    for fn in (init_paged_kv_caches, params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
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
