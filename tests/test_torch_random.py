"""The port's seed domains (``megatron_llm_torch/random.py``, the
counterpart of ``megatron_llm_tpu/random.py``): keys are 64-bit integers
and every stream is a function of its tuple alone.  Along the chain the
trainer and the model take (step, micro-batch, embedding or layer, site)
the same tuple gives the same key and the same mask; any other tuple
gives another key, and ``split`` gives keys distinct from each other and
from their parent."""

import itertools

import pytest
import torch

from megatron_llm_tpu import random as jrandom
from megatron_llm_torch import random as mrandom

torch.set_num_threads(1)


def test_domains_are_the_jax_package_s():
    assert {d.name: int(d) for d in mrandom.RngDomain} == {
        d.name: int(d) for d in jrandom.RngDomain}


def _tuples():
    return itertools.product(range(3), range(2), range(4), range(3))


def _site_keys(base, step, micro, num_layers=4):
    """The dropout keys of a micro-batch as the trainer and the model
    derive them: the step's key folded with the micro-batch, split into
    the embedding's and the stack's, the stack's split by layer and the
    layer's by site.  Returns (embedding key, [layer][site] keys)."""
    mkey = mrandom.fold_in(mrandom.fold_in(base, step), micro)
    k_embed, k_stack = mrandom.split(mkey)
    return k_embed, [mrandom.split(k, 3)
                     for k in mrandom.split(k_stack, num_layers)]


def test_streams_are_distinct_by_tuple_and_the_same_for_the_same_tuple():
    base = mrandom.base_key(1234)
    keys = {}
    for step, micro, layer, site in _tuples():
        k_embed, sites = _site_keys(base, step, micro)
        assert (k_embed, sites) == _site_keys(base, step, micro)
        k = sites[layer][site]
        assert 0 <= k < 2 ** 64
        keys[step, micro, layer, site] = k
        keys[step, micro, "embedding"] = k_embed
    assert len(set(keys.values())) == len(keys)
    assert mrandom.base_key(1234) != mrandom.base_key(1235)


def test_split_and_fold_in():
    k = mrandom.base_key(7)
    kids = mrandom.split(k, 5)
    assert len(set(kids)) == 5 and k not in kids
    assert mrandom.split(k, 5) == kids
    assert mrandom.split(k, 3) == kids[:3]
    assert mrandom.fold_in(k, 1) != mrandom.fold_in(k, 2)
    assert mrandom.fold_in(k, 2 ** 64 + 1) == mrandom.fold_in(k, 1)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 9)])
def test_masks_follow_their_key(shape):
    a = mrandom.bernoulli(11, 0.7, shape, "cpu")
    b = mrandom.bernoulli(11, 0.7, shape, "cpu")
    c = mrandom.bernoulli(12, 0.7, shape + (64,), "cpu")
    assert a.shape == shape and a.dtype == torch.bool
    assert torch.equal(a, b)
    assert not torch.equal(c, mrandom.bernoulli(11, 0.7, shape + (64,),
                                                "cpu"))
    # the draw does not touch the default generator
    torch.manual_seed(0)
    before = torch.rand(4)
    torch.manual_seed(0)
    mrandom.bernoulli(11, 0.7, shape, "cpu")
    assert torch.equal(torch.rand(4), before)


def test_key_seq_hands_out_fresh_keys():
    seq = mrandom.KeySeq(3)
    keys = [seq.next() for _ in range(6)]
    assert len(set(keys)) == 6
    assert [mrandom.KeySeq(3).next() for _ in range(1)] == keys[:1]
    assert mrandom.KeySeq(mrandom.base_key(3), is_key=True).next() == keys[0]
