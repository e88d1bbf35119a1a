"""Instruction-tuning dataset: parallel text + per-token role tracks (a copy of
``megatron_llm_tpu/data/instruction_dataset.py``).

Reference: ``megatron/data/instruction_dataset.py`` — two parallel indexed
datasets ``{prefix}-text`` / ``{prefix}-role`` (:26-52), epoch-sampled
indices (:152-168), and ``instruction_collator`` (:321-355) which pads to
``seq_length`` (or to the batch max under ``--variable_seq_lengths``) and
builds the assistant/pad masks; the loss is masked to assistant tokens
with ``--scalar_loss_mask`` elsewhere (finetune.py:155-166).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from megatron_llm_torch.data.indexed_dataset import MMapIndexedDataset

# per-token role ids written by tools/preprocess_instruct_data.py
ROLE_PAD = 0
ROLE_SYSTEM = 1
ROLE_USER = 2
ROLE_ASSISTANT = 3
ROLES = {"pad": ROLE_PAD, "system": ROLE_SYSTEM, "user": ROLE_USER,
         "assistant": ROLE_ASSISTANT}


class InstructionDataset:
    def __init__(
        self,
        data_prefix: str,
        num_samples: Optional[int] = None,
        seed: int = 1234,
        shuffle: bool = True,
    ):
        self.text = MMapIndexedDataset(data_prefix + "-text")
        self.role = MMapIndexedDataset(data_prefix + "-role")
        assert len(self.text) == len(self.role), (
            "text and role datasets must be parallel"
        )
        n_avail = len(self.text)
        if num_samples is None:
            num_samples = n_avail
        # epoch-sampled indices (reference :152-168): repeat + shuffle per
        # epoch so every sample appears once per epoch
        epochs = (num_samples + n_avail - 1) // n_avail
        rng = np.random.RandomState(seed)
        idx = []
        for e in range(epochs):
            perm = np.arange(n_avail)
            if shuffle:
                rng.shuffle(perm)
            idx.append(perm)
        self.sample_idx = np.concatenate(idx)[:num_samples]

    def __len__(self):
        return len(self.sample_idx)

    def __getitem__(self, idx: int):
        i = int(self.sample_idx[idx])
        return {
            "text": np.asarray(self.text[i], np.int64),
            "role": np.asarray(self.role[i], np.int64),
        }


def instruction_collator(
    micro_samples: Sequence[Sequence[dict]],
    seq_length: int,
    pad_token_id: int,
    variable_seq_lengths: bool = False,
    scalar_loss_mask: float = 0.0,
    divisible_by: int = 1,
):
    """Collate [num_micro][batch] samples into the train-step batch dict.

    reference: instruction_collator (instruction_dataset.py:321-355) +
    loss-mask assembly (finetune.py:155-166).  Sequences are truncated to
    ``seq_length + 1`` and padded to ``seq_length + 1`` (fixed) or the batch
    max rounded up to ``divisible_by`` (variable).
    """
    out_tokens, out_labels, out_mask = [], [], []
    for batch in micro_samples:
        max_len = seq_length + 1
        if variable_seq_lengths:
            longest = max(len(s["text"]) for s in batch)
            max_len = min(seq_length + 1,
                          -(-longest // divisible_by) * divisible_by)
        toks = np.full((len(batch), max_len), pad_token_id, np.int64)
        roles = np.full((len(batch), max_len), ROLE_PAD, np.int64)
        for r, s in enumerate(batch):
            t = s["text"][: max_len]
            toks[r, : len(t)] = t
            roles[r, : len(t)] = s["role"][: len(t)]
        tokens = toks[:, :-1]
        labels = toks[:, 1:]
        label_roles = roles[:, 1:]
        # loss on assistant tokens; scalar elsewhere; zero on pad
        loss_mask = np.where(
            label_roles == ROLE_ASSISTANT, 1.0,
            np.where(label_roles == ROLE_PAD, 0.0, scalar_loss_mask),
        ).astype(np.float32)
        out_tokens.append(tokens.astype(np.int32))
        out_labels.append(labels.astype(np.int32))
        out_mask.append(loss_mask)
    return {
        "tokens": np.stack(out_tokens),
        "labels": np.stack(out_labels),
        "loss_mask": np.stack(out_mask),
    }


def build_instruction_collator(seq_length, pad_token_id, **kw):
    def collate(micro_samples):
        return instruction_collator(micro_samples, seq_length, pad_token_id,
                                    **kw)
    return collate
