"""Wizard-of-Wikipedia preprocessing for multi-stage dialogue prompting.

Reference: ``tasks/msdp/preprocessing.py`` — turns the raw WoW json into
the ``topic \t dialogue \t knowledge \t response`` format the prompting
stage consumes, plus knowledge/response reference files for F1 scoring.
This is the functional core (WoW processing + prompt-file construction);
run with ``python -m megatron_llm_torch.tasks.msdp.preprocessing --func
...``.
"""

from __future__ import annotations

import argparse
import json
import random


def process_wow_dataset(raw_file: str, processed_file: str,
                        knwl_ref_file: str = None,
                        resp_ref_file: str = None):
    """WoW json -> one line per wizard turn:
    topic \t dialogue-so-far ([SEP] joined) \t checked knowledge \t response
    (reference: preprocessing.py:42-126)."""
    with open(raw_file) as f:
        data = json.load(f)

    n = 0
    with open(processed_file, "w") as out, \
         open(knwl_ref_file, "w") if knwl_ref_file else _null() as kout, \
         open(resp_ref_file, "w") if resp_ref_file else _null() as rout:
        for episode in data:
            topic = episode["chosen_topic"]
            turns = []
            for turn in episode["dialog"]:
                speaker = turn["speaker"]
                text = " ".join(turn["text"].split())
                if "Wizard" in speaker and turns:
                    # the wizard's checked knowledge sentence
                    checked = turn.get("checked_sentence", {})
                    knowledge = (next(iter(checked.values()))
                                 if checked else "no_passages_used")
                    dialogue = " [SEP] ".join(turns)
                    out.write(f"{topic}\t{dialogue}\t{knowledge}\t{text}\n")
                    if kout:
                        kout.write(knowledge + "\n")
                    if rout:
                        rout.write(text + "\n")
                    n += 1
                turns.append(text)
    print(f" > processed {n} wizard turns -> {processed_file}", flush=True)
    return n


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def build_knowledge_prompts(train_file: str, output_file: str,
                            n_examples: int = 10, seed: int = 1234,
                            test_file: str = None):
    """Few-shot prompt examples keyed by each TEST sample's
    ``topic + ' ' + last turn`` — the exact key ``prompt.build_input``
    looks up — with examples drawn from the processed training file
    (simplified form of the reference's similarity-based prompt selection,
    preprocessing.py:364-460; same-topic beats random)."""
    rng = random.Random(seed)
    by_topic = {}
    all_examples = []
    with open(train_file) as f:
        for line in f:
            topic, dialogue, knowledge, _resp = line.rstrip("\n").split("\t")
            if knowledge == "no_passages_used":
                continue
            last = dialogue.split(" [SEP] ")[-1]
            ex = f"( {last} ) {topic} => {knowledge}"
            by_topic.setdefault(topic, []).append(ex)
            all_examples.append(ex)

    def select(topic):
        pool = list(by_topic.get(topic, []))
        if len(pool) < n_examples:
            extra = [e for e in all_examples if e not in pool]
            rng.shuffle(extra)
            pool += extra[: n_examples - len(pool)]
        else:
            rng.shuffle(pool)
        return pool[:n_examples]

    # the keys must come from the file generation will run on
    key_source = test_file or train_file
    written = set()
    with open(key_source) as f, open(output_file, "w") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            topic, dialogue = parts[0], parts[1]
            last = dialogue.split(" [SEP] ")[-1]
            key = f"{topic} {last}"
            if key in written:
                continue
            written.add(key)
            out.write(json.dumps({key: select(topic)}) + "\n")
    print(f" > wrote knowledge prompts for {len(written)} samples "
          f"-> {output_file}", flush=True)


def build_response_prompts(train_file: str, output_file: str,
                           n_examples: int = 10, seed: int = 1234):
    """Fixed response-generation examples (reference:
    preprocessing.py:462-531, random selection variant)."""
    rng = random.Random(seed)
    rows = []
    with open(train_file) as f:
        for line in f:
            topic, dialogue, knowledge, resp = line.rstrip("\n").split("\t")
            if knowledge == "no_passages_used":
                continue
            context = dialogue
            rows.append(f"Topic: {topic}. Knowledge: {knowledge} "
                        f"Context: {context} Response: {resp}")
    rng.shuffle(rows)
    with open(output_file, "w") as out:
        for row in rows[:n_examples]:
            out.write(row + "\n")
    print(f" > wrote response prompts -> {output_file}", flush=True)


def prepare_input_for_response_generation(test_file: str,
                                          knwl_gen_file: str,
                                          processed_file: str):
    """Splice generated knowledge into the test file as column 3
    (reference: preprocessing.py:533-581)."""
    with open(test_file) as ft, open(knwl_gen_file) as fk, \
         open(processed_file, "w") as out:
        for line, knowledge in zip(ft, fk):
            topic, dialogue = line.rstrip("\n").split("\t")[:2]
            out.write(f"{topic}\t{dialogue}\t{knowledge.strip()}\n")
    print(f" > wrote response-generation inputs -> {processed_file}",
          flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--func", required=True,
                   choices=["process_wow_dataset", "build_knowledge_prompts",
                            "build_response_prompts",
                            "prepare_input_for_response_generation"])
    p.add_argument("--raw_file")
    p.add_argument("--processed_file")
    p.add_argument("--knwl_ref_file")
    p.add_argument("--resp_ref_file")
    p.add_argument("--train_file")
    p.add_argument("--test_file")
    p.add_argument("--knwl_gen_file")
    p.add_argument("--output_file")
    p.add_argument("--n_examples", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args()

    if args.func == "process_wow_dataset":
        process_wow_dataset(args.raw_file, args.processed_file,
                            args.knwl_ref_file, args.resp_ref_file)
    elif args.func == "build_knowledge_prompts":
        build_knowledge_prompts(args.train_file, args.output_file,
                                args.n_examples, args.seed,
                                test_file=args.test_file)
    elif args.func == "build_response_prompts":
        build_response_prompts(args.train_file, args.output_file,
                               args.n_examples, args.seed)
    else:
        prepare_input_for_response_generation(
            args.test_file, args.knwl_gen_file, args.processed_file)


if __name__ == "__main__":
    main()
