"""MSDP evaluation: token F1 between a generation file and a reference file
(reference: tasks/msdp/evaluate.py; a copy of the root package's, whose
``main`` takes the parsed flags)."""

from __future__ import annotations

from megatron_llm_torch.tasks.msdp.metrics import F1Metric


def evaluate_f1(guess_file: str, answer_file: str):
    guesses = []
    with open(guess_file) as f:
        for line in f:
            line = line.strip().replace("<|endoftext|>", "")
            guesses.append(line)
    answers = []
    with open(answer_file) as f:
        for line in f:
            line = line.strip()
            if line == "no_passages_used":
                line = ""
            answers.append(line)
    assert len(guesses) == len(answers), \
        "lengths of guess and answer files differ"
    p, r, f1 = F1Metric.compute_all_pairs(guesses, answers)
    print(f"Precision: {p:.4f}; recall: {r:.4f}; f1: {f1:.4f}", flush=True)
    return p, r, f1


def main(args, tokenizer=None):
    return evaluate_f1(args.guess_file, args.answer_file)
