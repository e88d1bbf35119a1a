"""The port's data pipeline (megatron_llm_torch/data/) against the JAX
package's, on the same seeded inputs: mmap files written by either
package read in the other with the same bytes; the native index helpers
(built with g++ into build/torch_helpers/) equal their plain numpy
versions and the JAX package's; GPTDataset, split and blended, yields the
same samples (and the two share index caches); the samplers give the
same index batches at every consumed_samples; the loader the same
batches; the instruction collator the same tokens, labels and masks."""

import os
import shutil

import numpy as np
import pytest

from megatron_llm_tpu.data import data_samplers as jax_samplers
from megatron_llm_tpu.data import gpt_dataset as jax_gpt
from megatron_llm_tpu.data import helpers as jax_helpers
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.data import instruction_dataset as jax_inst
from megatron_llm_torch.data import data_samplers as samplers
from megatron_llm_torch.data import gpt_dataset, helpers
from megatron_llm_torch.data import indexed_dataset as idx
from megatron_llm_torch.data import instruction_dataset as inst


def _docs(seed, n=60, lo=3, hi=90, vocab=1000):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(lo, hi)) for _ in range(n)]


def _write(module, prefix, docs, dtype):
    b = module.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=dtype)
    for d in docs:
        b.add_item(d)
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _bytes(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".bin", ".idx")]


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_mmap_files_read_across_packages(tmp_path, dtype):
    docs = _docs(0)
    p_t = _write(idx, str(tmp_path / "torch"), docs, dtype)
    p_j = _write(jax_idx, str(tmp_path / "jax"), docs, dtype)
    assert _bytes(p_t) == _bytes(p_j)
    for reader, prefix in ((jax_idx, p_t), (idx, p_j)):
        ds = reader.MMapIndexedDataset(prefix)
        assert len(ds) == len(docs) and ds.dtype == np.dtype(dtype)
        for i, d in enumerate(docs):
            np.testing.assert_array_equal(ds[i], d)
        np.testing.assert_array_equal(ds.get(3, offset=1, length=2),
                                      docs[3][1:3])
        np.testing.assert_array_equal(ds.doc_idx, np.arange(len(docs) + 1))


def test_merge_and_builder_match_jax(tmp_path):
    a = _write(idx, str(tmp_path / "a"), _docs(1, n=5), np.uint16)
    b = _write(idx, str(tmp_path / "b"), _docs(2, n=7), np.uint16)
    outs = []
    for module, name in ((idx, "mt"), (jax_idx, "mj")):
        out = str(tmp_path / name)
        builder = module.make_builder(out + ".bin", vocab_size=32000)
        builder.merge_file_(a)
        builder.merge_file_(b)
        builder.finalize(out + ".idx")
        outs.append(_bytes(out))
    assert outs[0] == outs[1]
    assert idx.best_fitting_dtype(32000) == jax_idx.best_fitting_dtype(32000)


SAMPLE_IDX_CASES = [(0, 200, 32, 150), (1, 50, 7, 60), (2, 500, 128, 40)]


@pytest.mark.parametrize("seed,ndocs,seq,nsamples", SAMPLE_IDX_CASES)
def test_build_sample_idx_native_plain_and_jax(seed, ndocs, seq, nsamples):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 60, size=ndocs).astype(np.int32)
    doc_idx = np.tile(np.arange(ndocs), 4).astype(np.int64)
    rng.shuffle(doc_idx)
    got = helpers.build_sample_idx(sizes, doc_idx, seq, nsamples)
    assert helpers.using_native()
    np.testing.assert_array_equal(
        got, helpers._build_sample_idx_py(sizes, doc_idx, seq, nsamples))
    np.testing.assert_array_equal(
        got, jax_helpers.build_sample_idx(sizes, doc_idx, seq, nsamples))


def test_blending_and_mappings_native_plain_and_jax():
    w = np.array([0.5, 0.3, 0.2])
    got = helpers.build_blending_indices(w, 1000)
    for want in (helpers._build_blending_indices_py(w, 1000),
                 jax_helpers.build_blending_indices(w, 1000)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    rng = np.random.RandomState(3)
    sizes = rng.randint(5, 60, size=300).astype(np.int32)
    doc_idx = np.concatenate([[0], np.cumsum(rng.randint(1, 8, 60))])
    doc_idx = doc_idx[doc_idx <= 300].astype(np.int64)
    np.testing.assert_array_equal(
        helpers.build_mapping(doc_idx, sizes, 2, 100, 64, 0.1, 7),
        jax_helpers.build_mapping(doc_idx, sizes, 2, 100, 64, 0.1, 7))
    titles = rng.randint(1, 5, size=len(doc_idx)).astype(np.int32)
    np.testing.assert_array_equal(
        helpers.build_blocks_mapping(doc_idx, sizes, titles, 2, 100, 128,
                                     7),
        jax_helpers.build_blocks_mapping(doc_idx, sizes, titles, 2, 100,
                                         128, 7))


def test_a_failed_helper_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(helpers, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", shutil.which("false") or "/bin/false")
    with pytest.raises(RuntimeError, match="building the data helpers"):
        helpers.build()
    assert not list((tmp_path / "b").glob("*.so"))


def test_helper_library_is_digest_named():
    so = helpers.build()
    assert so.parent == helpers.BUILD_DIR and so.name.startswith(
        "libhelpers_") and so.exists()


def _corpora(tmp_path, sub):
    d = tmp_path / sub
    d.mkdir()
    return [_write(idx, str(d / f"c{i}"), _docs(10 + i, n=40), np.uint16)
            for i in range(2)]


@pytest.mark.parametrize("blend", [False, True], ids=["split", "blend"])
def test_gpt_datasets_yield_the_same_samples(tmp_path, blend):
    pt, pj = _corpora(tmp_path, "t"), _corpora(tmp_path, "j")
    prefixes = ((lambda ps: ["0.7", ps[0], "0.3", ps[1]]) if blend
                else (lambda ps: [ps[0]]))
    nums, seq, seed = [30, 8, 4], 16, 1234
    got = gpt_dataset.build_train_valid_test_datasets(
        prefixes(pt), "80,15,5", nums, seq, seed)
    want = jax_gpt.build_train_valid_test_datasets(
        prefixes(pj), "80,15,5", nums, seq, seed)
    # the index caches carry the JAX package's names: the JAX package
    # reads the port's cached files and gives the same samples again
    cached = sorted(f for f in os.listdir(os.path.dirname(pt[0]))
                    if f.endswith(".npy"))
    assert cached and cached == sorted(
        f for f in os.listdir(os.path.dirname(pj[0])) if f.endswith(".npy"))
    from_cache = jax_gpt.build_train_valid_test_datasets(
        prefixes(pt), "80,15,5", nums, seq, seed)
    for g, w, c in zip(got, want, from_cache):
        assert (g is None) == (w is None) == (c is None)
        if g is None:
            continue
        assert len(g) == len(w) == len(c)
        for i in range(len(g)):
            np.testing.assert_array_equal(g[i]["text"], w[i]["text"])
            np.testing.assert_array_equal(c[i]["text"], w[i]["text"])
    assert jax_gpt.get_train_valid_test_split_("98,2,0", 2000) == \
        gpt_dataset.get_train_valid_test_split_("98,2,0", 2000)


@pytest.mark.parametrize("consumed", [0, 4, 6, 22, 58])
def test_samplers_match_jax(consumed):
    for cls in ("MegatronPretrainingSampler",
                "MegatronPretrainingRandomSampler"):
        kw = dict(total_samples=61, consumed_samples=consumed,
                  micro_batch_size=2, data_parallel_size=1)
        if cls.endswith("RandomSampler"):
            kw["seed"] = 99
        got = iter(getattr(samplers, cls)(**kw))
        want = iter(getattr(jax_samplers, cls)(**kw))
        for _ in range(40):
            a, b = next(got, None), next(want, None)
            if a is None or b is None:
                assert a is None and b is None
                break
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["single", "cyclic"])
def test_loader_batches_match_jax(tmp_path, kind):
    prefix = _corpora(tmp_path, "c")[0]
    ds_t = gpt_dataset.build_train_valid_test_datasets(
        [prefix], "100,0,0", [24, 0, 0], 16, 5)[0]
    ds_j = jax_gpt.build_train_valid_test_datasets(
        [prefix], "100,0,0", [24, 0, 0], 16, 5)[0]
    got = samplers.build_pretraining_data_loader(
        ds_t, 4, 2, 1, 2, kind, seed=5, prefetch=2)
    want = jax_samplers.build_pretraining_data_loader(
        ds_j, 4, 2, 1, 2, kind, seed=5, prefetch=0)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["labels", "loss_mask", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == (2, 2, 16)
            np.testing.assert_array_equal(a[k], b[k])


def _instruction_corpus(module, prefix, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 40, size=12)
    texts = [rng.randint(1, 500, n) for n in lens]
    roles = [rng.choice([inst.ROLE_SYSTEM, inst.ROLE_USER,
                         inst.ROLE_ASSISTANT], n) for n in lens]
    _write(module, prefix + "-text", texts, np.int32)
    _write(module, prefix + "-role", roles, np.int32)
    return prefix


@pytest.mark.parametrize("variable", [False, True],
                         ids=["fixed", "variable"])
def test_instruction_collator_matches_jax(tmp_path, variable):
    pt = _instruction_corpus(idx, str(tmp_path / "it"), 8)
    pj = _instruction_corpus(jax_idx, str(tmp_path / "ij"), 8)
    ds_t = inst.InstructionDataset(pt, num_samples=20, seed=3)
    ds_j = jax_inst.InstructionDataset(pj, num_samples=20, seed=3)
    np.testing.assert_array_equal(ds_t.sample_idx, ds_j.sample_idx)
    kw = dict(variable_seq_lengths=variable, scalar_loss_mask=0.25,
              divisible_by=8)
    micros_t = [[ds_t[i] for i in range(k, k + 3)] for k in (0, 3)]
    micros_j = [[ds_j[i] for i in range(k, k + 3)] for k in (0, 3)]
    a = inst.build_instruction_collator(24, 0, **kw)(micros_t)
    b = jax_inst.build_instruction_collator(24, 0, **kw)(micros_j)
    assert sorted(a) == sorted(b) == ["labels", "loss_mask", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["loss_mask"] == 0.25).any() and (a["loss_mask"] == 1).any()


def test_prefetch_thread_error_reaches_the_consumer():
    """A dataset that fails inside the prefetch thread fails the
    consumer's next() with that error, after the batches before it."""

    class Corrupt:
        def __len__(self):
            return 40

        def __getitem__(self, i):
            if i >= 8:
                raise IndexError(f"corrupt sample {i}")
            return {"text": np.full(17, i, np.int64)}

    it = samplers.build_pretraining_data_loader(
        Corrupt(), 0, 2, 1, 2, "single", seed=5, prefetch=2)
    for _ in range(2):      # samples 0-7
        assert next(it)["tokens"].shape == (2, 2, 16)
    with pytest.raises(IndexError, match="corrupt sample 8"):
        next(it)
