"""The PyTorch port stands alone: every module (the ``weights_conversion/``
and ``tools/`` subpackages, ``verify_correctness.py`` and the tensor
parallelism's ``topology``, ``initialize`` and ``parallel/``, the
pipeline's ``parallel/pipeline.py`` among them, included)
and the tensor-parallel worlds' helper of the tests
(``tests/_torch_tp_world.py``) import with ``jax``, ``orbax``,
``tensorstore``, the JAX package and the repo's root modules
(``weights_conversion``, ``tools``, ``tasks``, ``finetune``,
``verify_correctness``) blocked, no file of the port (or chip_smoke.py,
or that helper) imports any of them, entry points default to the GPU, and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""

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
from megatron_llm_torch.text_generation.generation import (
    init_kv_caches,
    init_paged_kv_caches,
)
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "megatron_llm_torch")
# the helper that runs the tests' tensor-parallel worlds: its ranks import
# the port and nothing of JAX
TP_WORLD = os.path.join(REPO, "tests", "_torch_tp_world.py")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    return [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
            .removesuffix(".__init__") for p in _port_files()]


# the JAX package, its dependencies and the repo's root modules
BANNED = ("jax", "jaxlib", "megatron_llm_tpu", "orbax", "tensorstore",
          "weights_conversion", "tools", "tasks", "finetune",
          "verify_correctness", "pretrain_gpt", "pretrain_bert",
          "pretrain_t5", "pretrain_ict")


def test_every_port_module_imports_with_jax_blocked():
    mods = _modules()
    for sub in ("weights_conversion", "tools", "verify_correctness",
                "serving.drafter", "serving.host_cache",
                "serving.resilience", "serving.alerts", "serving.router",
                "serving.supervisor", "tools.serve_router",
                "tools.serve_fleet", "quantization",
                "text_generation.generation", "text_generation.api",
                "models.bert", "models.t5", "models.biencoder",
                "models.classification", "indexer", "pretrain_entry",
                "pretrain_bert", "pretrain_t5", "pretrain_ict",
                "tools.create_doc_index", "data.dataset_utils",
                "data.bert_dataset", "data.t5_dataset", "data.ict_dataset",
                "data.orqa_wiki_dataset", "data.realm_index",
                "tasks", "tasks.main", "tasks.finetune_utils",
                "tasks.glue.finetune", "tasks.race.finetune",
                "tasks.zeroshot_gpt.evaluate", "tasks.zeroshot_gpt.mc_tasks",
                "tasks.orqa.evaluate_orqa", "tasks.msdp.prompt",
                "tools.bench_harness", "tools.profile_step",
                "tools.decode_bench", "tools.mfu_sweep", "topology",
                "initialize", "parallel.mappings", "parallel.sharding",
                "parallel.layers", "parallel.pipeline"):
        assert any(m.startswith(f"megatron_llm_torch.{sub}") for m in mods)
    code = ("import importlib, sys\n"
            f"for b in {BANNED!r}:\n"
            "    sys.modules[b] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"sys.path.insert(0, {os.path.dirname(TP_WORLD)!r})\n"
            "importlib.import_module('_torch_tp_world')\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    banned = BANNED
    for path in _port_files() + [os.path.join(REPO, "chip_smoke.py"),
                                 TP_WORLD]:
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


def test_entry_points_default_to_the_gpu(tmp_path):
    model = LlamaModel(llama_config("tiny"))
    assert model.device.type == "cuda"
    from megatron_llm_torch.models.bert import BertModel, bert_config
    from megatron_llm_torch.models.biencoder import BiEncoderModel
    from megatron_llm_torch.models.t5 import T5Model, t5_config
    for m in (BertModel(bert_config()), T5Model(t5_config()),
              BiEncoderModel(bert_config())):
        assert m.device.type == "cuda"
    args = build_parser().parse_args(["--model_name", "llama2"])
    assert args.device == "cuda"
    for fn in (init_paged_kv_caches, init_kv_caches, params_from_jax,
               finetune.build_data_iterator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert build_train_parser().parse_args([]).device == "cuda"
    from megatron_llm_torch.tasks import main as tasks_main
    tasks_args, _ = tasks_main.parse(["--task", "PIQA", "--vocab_size",
                                      "64"])
    assert tasks_args.device == "cuda"
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
        from megatron_llm_torch import (pretrain_bert, pretrain_ict,
                                        pretrain_t5)
        for entry in (pretrain_bert, pretrain_t5, pretrain_ict):
            with pytest.raises((AssertionError, RuntimeError)):
                entry.main(tiny[1:])
        # the tasks and the perf tools reach for the card too
        lm = tmp_path / "lm.tokens"
        lm.write_text(" ".join(str(i % 50) for i in range(40)))
        with pytest.raises((AssertionError, RuntimeError)):
            tasks_main.main(["--task", "WIKITEXT103", "--valid_data",
                             str(lm), "--tokenizer_type", "NullTokenizer",
                             *tiny[1:]])
        from megatron_llm_torch.tools import (decode_bench, mfu_sweep,
                                              profile_step)
        with pytest.raises((AssertionError, RuntimeError)):
            profile_step.main(["--preset", "tiny", "--logdir",
                               str(tmp_path / "trace")])
        with pytest.raises((AssertionError, RuntimeError)):
            decode_bench.main(["--preset", "tiny"])
        # a sweep reports a failed trial and exits 1
        assert mfu_sweep.main(["tiny"]) == 1
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
