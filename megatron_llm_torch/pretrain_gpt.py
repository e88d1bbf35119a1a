"""GPT pretraining entry point: ``finetune.py`` with ``--model_name=gpt``
unless the caller names another family (the root ``pretrain_gpt.py``'s
alias for the port).

    python -m megatron_llm_torch.pretrain_gpt --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 1024 \\
        --max_position_embeddings 1024 --micro_batch_size 4 \\
        --global_batch_size 8 --train_iters 500000 \\
        --lr_decay_iters 320000 --lr 0.00015 --min_lr 1e-5 \\
        --lr_decay_style cosine --lr_warmup_fraction 0.01 \\
        --weight_decay 0.01 --clip_grad 1.0 --bf16 \\
        --data_path corpus_text_document --split 949,50,1 \\
        --tokenizer_type GPT2BPETokenizer --vocab_file gpt2-vocab.json \\
        --merge_file gpt2-merges.txt
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from megatron_llm_torch import finetune


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--model_name") for a in argv):
        argv.append("--model_name=gpt")
    return finetune.main(argv)


if __name__ == "__main__":
    main()
