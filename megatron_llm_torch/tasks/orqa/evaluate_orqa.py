"""Open-retrieval QA zero-shot evaluation (ICT-ZEROSHOT-NQ /
RETRIEVER-EVAL).

Reference: ``tasks/orqa/evaluate_orqa.py`` + ``evaluate_utils.py`` — embed
the questions with the query tower, retrieve top-k evidence blocks from the
precomputed index, and report answer recall@k (an answer string appearing
in a retrieved block counts).

Input file: jsonl or TSV with fields question / answers (list).

The counterpart of the root ``tasks/orqa/evaluate_orqa.py``: the query
tower embeds on the model's device under ``torch.inference_mode``; the
evidence store is built on one process (rank 0 of 1) by the port's
``EvidenceIndexBuilder``; the exact MIPS search runs in numpy, as in the
root package.
"""

from __future__ import annotations

import ast
import json
import re

import numpy as np
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch.data.realm_index import (
    BruteForceMIPSIndex,
    OpenRetrievalDataStore,
)
from megatron_llm_torch.models.biencoder import BiEncoderModel
from megatron_llm_torch.tasks.model_utils import bert_task_config


def load_qa_pairs(path):
    """[(question, [answers])] from jsonl ({question, answers}) or TSV."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                rec = json.loads(line)
                q, answers = rec["question"], rec["answers"]
            else:
                q, ans = line.split("\t", 1)
                try:
                    # DPR-style python-literal answer list; literal_eval
                    # cannot execute expressions from the data file (it can
                    # still raise TypeError/RecursionError/MemoryError on
                    # hostile input — any failure means "plain string")
                    answers = ast.literal_eval(ans)
                except Exception:
                    answers = [ans]
                if not isinstance(answers, (list, tuple)):
                    answers = [str(answers)]
            pairs.append((q, list(answers)))
    return pairs


def _regex_match(answer, text):
    try:
        return re.search(re.compile(answer, flags=re.IGNORECASE),
                         text) is not None
    except re.error:
        return False


def answer_in_block(answers, block_text, match="string"):
    lowered = block_text.lower()
    for a in answers:
        if match == "regex":
            if _regex_match(a, block_text):
                return True
        elif a.lower() in lowered:
            return True
    return False


def _recall_eval(model, params, index, qa_pairs, *, build_query,
                 resolve_text, topk_list, match, batch_size):
    """Shared recall@k loop: embed query batches, MIPS search, resolve
    each retrieved id to text, tally hits by rank.  ``build_query(q) ->
    (ids, pad_mask)``; ``resolve_text(doc_id) -> str or None``."""
    max_k = max(topk_list)
    dev = model.device

    @torch.inference_mode()
    def embed(params, toks, mask):
        return model.embed_query(params, toks, mask).float().cpu().numpy()

    hits = {k: 0 for k in topk_list}
    n = 0
    for lo in range(0, len(qa_pairs), batch_size):
        chunk = qa_pairs[lo:lo + batch_size]
        pairs = [build_query(q) for q, _ in chunk]
        emb = embed(
            params,
            torch.from_numpy(np.stack([p[0] for p in pairs]).astype(
                np.int64)).to(dev),
            torch.from_numpy(np.stack([p[1] for p in pairs]).astype(
                np.int32)).to(dev))
        _, ids_topk = index.search_mips_index(emb, top_k=max_k)
        for (q, answers), row_ids in zip(chunk, ids_topk):
            found_rank = None
            for rank, doc_id in enumerate(row_ids):
                text = resolve_text(int(doc_id))
                if text is None:
                    continue
                if answer_in_block(answers, text, match):
                    found_rank = rank
                    break
            n += 1
            for k in topk_list:
                if found_rank is not None and found_rank < k:
                    hits[k] += 1
    return {f"recall@{k}": hits[k] / max(n, 1) for k in topk_list}, n


def evaluate_retriever(model, params, ict_dataset, index, qa_pairs,
                       tokenizer, topk_list=(1, 5, 20, 100), match="string",
                       batch_size=32):
    """Recall@k over the qa pairs; blocks detokenized for answer match."""
    # block id -> row for text reconstruction
    mapping = np.asarray(ict_dataset.samples_mapping)
    by_block = {int(r[3]): (int(r[0]), int(r[1]), int(r[2]))
                for r in mapping}

    def build_query(q):
        ids = tokenizer.tokenize(q)[: ict_dataset.max_seq_length - 2]
        return ict_dataset.concat_and_pad_tokens(ids)

    def resolve_text(bid):
        if bid not in by_block:
            return None
        start, end, doc = by_block[bid]
        block_tokens, _ = ict_dataset.get_block(start, end, doc)
        return tokenizer.detokenize(
            [int(t) for t in block_tokens
             if int(t) != ict_dataset.pad_id])

    return _recall_eval(model, params, index, qa_pairs,
                        build_query=build_query, resolve_text=resolve_text,
                        topk_list=topk_list, match=match,
                        batch_size=batch_size)


def evaluate_retriever_wiki(model, params, evidence_ds, index, qa_pairs,
                            tokenizer, topk_list=(1, 5, 20, 100),
                            match="string", batch_size=32):
    """Recall@k against a TSV evidence corpus: retrieved doc_ids resolve
    through ``id2text`` (title + text) for answer matching — the
    reference's RETRIEVER-EVAL scoring (tasks/orqa/unsupervised/nq.py)
    over orqa_wiki_dataset evidence."""
    from megatron_llm_torch.data.orqa_wiki_dataset import (
        build_tokens_types_paddings_from_ids,
    )

    seq_len = evidence_ds.max_seq_length

    def build_query(q):
        ids, _, pad_mask = build_tokens_types_paddings_from_ids(
            tokenizer.tokenize(q), seq_len, tokenizer.cls,
            tokenizer.sep, tokenizer.pad)
        return ids, pad_mask

    def resolve_text(doc_id):
        entry = evidence_ds.id2text.get(doc_id)
        if entry is None:
            return None
        text, title = entry
        return f"{title} {text}"

    return _recall_eval(model, params, index, qa_pairs,
                        build_query=build_query, resolve_text=resolve_text,
                        topk_list=topk_list, match=match,
                        batch_size=batch_size)


def _main_wiki_evidence(args, tokenizer, model, params, evidence):
    """RETRIEVER-EVAL over a DPR wiki TSV, end to end: build the evidence
    dataset, embed it with the context tower into the embedding store
    (when absent), then report recall@k (reference workflow:
    orqa_wiki_dataset -> indexer -> evaluate_utils)."""
    import os

    from megatron_llm_torch.data.orqa_wiki_dataset import (
        OpenRetrievalEvidenceDataset,
    )
    from megatron_llm_torch.indexer import EvidenceIndexBuilder

    seq_len = (getattr(args, "retriever_seq_length", None)
               or args.seq_length)
    evidence_ds = OpenRetrievalEvidenceDataset(
        evidence, tokenizer, seq_len,
        sample_rate=getattr(args, "sample_rate", 1.0), seed=args.seed)

    embedding_path = args.embedding_path
    if not embedding_path:
        raise SystemExit("need --embedding_path")
    if not os.path.exists(embedding_path):
        rank, world = 0, 1      # the port indexes on one process
        print(f" > embedding store {embedding_path} absent: embedding "
              f"{len(evidence_ds)} evidence rows "
              f"(rank {rank}/{world})", flush=True)
        # one process: EvidenceIndexBuilder merges its one shard at once
        EvidenceIndexBuilder(
            model, params, evidence_ds, embedding_path,
            batch_size=getattr(args, "indexer_batch_size", 128),
            rank=rank, world_size=world,
            log_interval=getattr(args, "indexer_log_interval", 0),
        ).build_and_save_index()
    elif getattr(args, "sample_rate", 1.0) < 1.0:
        print(f" > WARNING: reusing existing embedding store "
              f"{embedding_path}; --sample_rate has no effect on it "
              f"(delete the store to re-embed a subsample)", flush=True)

    embed_dim = (getattr(args, "biencoder_projection_dim", 0)
                 or args.hidden_size)
    store = OpenRetrievalDataStore(embedding_path)
    index = BruteForceMIPSIndex(embed_dim, store)

    qa_path = args.qa_data_dev or args.qa_data_test
    if qa_path is None:
        raise SystemExit("need --qa_data_dev or --qa_data_test")
    qa_pairs = load_qa_pairs(qa_path)
    topk = tuple(getattr(args, "retriever_report_topk_accuracies", None)
                 or (1, 5, 20, 100))
    results, n = evaluate_retriever_wiki(
        model, params, evidence_ds, index, qa_pairs, tokenizer,
        topk_list=topk, match=getattr(args, "faiss_match", "string"))
    print(f" > evaluated {n} questions")
    for k, v in results.items():
        print(f"   {k}: {v * 100:.2f}%", flush=True)
    return results


def main(args, tokenizer):
    model = BiEncoderModel(
        bert_task_config(args),
        projection_dim=getattr(args, "biencoder_projection_dim", 0),
        shared_query_context=getattr(
            args, "biencoder_shared_query_context_model", False),
        device=args.device,
    )
    params = None
    load_dir = args.load or getattr(args, "ict_load", None) \
        or getattr(args, "bert_load", None)
    if load_dir:
        params, _, _ = checkpointing.load_checkpoint(
            load_dir, finetune=True, params_template=model.template(),
            device=model.device)
    if params is None:
        print(" > WARNING: evaluating a randomly initialized retriever",
              flush=True)
        params = model.init(args.seed)
    evidence = getattr(args, "evidence_data_path", None) or (
        args.data_path[0] if isinstance(args.data_path, list)
        else args.data_path)

    if str(evidence).endswith(".tsv"):
        # DPR wiki-TSV evidence (reference RETRIEVER-EVAL workflow):
        # TSV -> evidence dataset -> context-tower embedding (built here
        # when the store is absent) -> MIPS -> recall@k over id2text
        return _main_wiki_evidence(args, tokenizer, model, params, evidence)

    # evidence: the ICT dataset over the full corpus + the embedding store
    from megatron_llm_torch.data.dataset_utils import get_indexed_dataset_
    from megatron_llm_torch.data.ict_dataset import ICTDataset
    blocks = get_indexed_dataset_(evidence)
    titles = get_indexed_dataset_(args.titles_data_path)
    ict = ICTDataset(
        name="full", block_dataset=blocks, title_dataset=titles,
        data_prefix=evidence,
        num_epochs=1, max_num_samples=None,
        max_seq_length=(getattr(args, "retriever_seq_length", None)
                        or args.seq_length),
        query_in_block_prob=1.0,
        seed=1, tokenizer=tokenizer,
        use_one_sent_docs=getattr(args, "use_one_sent_docs", False))

    embed_dim = (getattr(args, "biencoder_projection_dim", 0)
                 or args.hidden_size)
    store = OpenRetrievalDataStore(args.embedding_path)
    index = BruteForceMIPSIndex(embed_dim, store)

    qa_path = args.qa_data_dev or args.qa_data_test
    if qa_path is None:
        raise SystemExit("need --qa_data_dev or --qa_data_test")
    qa_pairs = load_qa_pairs(qa_path)
    topk = tuple(getattr(args, "retriever_report_topk_accuracies", None)
                 or (1, 5, 20, 100))
    results, n = evaluate_retriever(
        model, params, ict, index, qa_pairs, tokenizer,
        topk_list=topk, match=getattr(args, "faiss_match", "string"))
    print(f" > evaluated {n} questions")
    for k, v in results.items():
        print(f"   {k}: {v * 100:.2f}%", flush=True)
    return results
