"""Multi-stage dialogue prompting: knowledge + response generation.

Reference: ``tasks/msdp/prompt.py`` — each test line is
``topic \t dialogue turns ([SEP]-separated) [\t knowledge]``; a few-shot
prompt is prepended (per-key for knowledge generation, fixed for response
generation) and the LM completes it; generation stops at the first newline.

The counterpart of the root ``tasks/msdp/prompt.py``: the port's
legacy generation path (``text_generation.api.generate``, greedy, with
the KV cache) decodes one prompt per call on the model's device; the
completion is sliced at the prompt's token length.
"""

from __future__ import annotations

import json


def read_knowledge_prompts(prompt_file: str) -> dict:
    """{topic + ' ' + last_turn: few-shot prompt string} (reference:
    prompt.py:183-197)."""
    prompts = {}
    with open(prompt_file) as f:
        for line in f:
            record = json.loads(line.strip())
            key = next(iter(record))
            if key not in prompts:
                prompts[key] = "".join(
                    inst.strip() + " \n" for inst in record[key])
    return prompts


def read_response_prompt(prompt_file: str, n_examples: int) -> str:
    with open(prompt_file) as f:
        lines = f.readlines()[:n_examples]
    return "".join(line.strip() + " \n" for line in lines)


def build_input(line: str, prompt_type: str, knowledge_prompts=None,
                response_prompt: str = "") -> str:
    """One test line -> full LM input (reference: prompt.py:218-286)."""
    splits = line.strip().split("\t")
    topic = splits[0]
    turns = splits[1].split(" [SEP] ")
    last_turn = turns[-1]
    if prompt_type == "knowledge":
        key = f"{topic} {last_turn}"
        prompt = knowledge_prompts.get(key, "")
        return f"{prompt}( {last_turn} ) {topic} =>"
    # response generation: context is all turns + generated knowledge
    knowledge = splits[2] if len(splits) > 2 else ""
    context = " [SEP] ".join(turns)
    return (f"{response_prompt}Topic: {topic}. "
            f"Knowledge: {knowledge.strip()} "
            f"Context: {context} Response:")


def postprocess_generation(text: str) -> str:
    """Take the first line of the completion, strip the eod marker.  Any
    line break ends the line (``str.splitlines``: ``\\r`` too, which the
    root package keeps, so a generated ``\\r`` split its output file's
    line when read back in text mode)."""
    text = text.replace("<|endoftext|>", "")
    lines = text.strip().splitlines()
    return lines[0].strip() if lines else ""


def generate_samples_by_prompting_input_from_file(model, params, tokenizer,
                                                  args):
    """Reference: prompt.py:155-286."""
    from megatron_llm_torch.text_generation.api import generate

    assert args.sample_input_file, "need --sample_input_file"
    out_path = (args.sample_output_file
                or args.sample_input_file + ".out")
    assert args.prompt_type in ("knowledge", "response")

    knowledge_prompts = None
    response_prompt = ""
    if args.prompt_type == "knowledge":
        knowledge_prompts = read_knowledge_prompts(args.prompt_file)
    else:
        response_prompt = read_response_prompt(args.prompt_file,
                                               args.num_prompt_examples)

    with open(args.sample_input_file) as fin, open(out_path, "w") as fout:
        for i, line in enumerate(fin):
            if not line.strip():
                # keep output line-aligned with the input file (the
                # response stage zips them back together)
                fout.write("\n")
                continue
            raw = build_input(line, args.prompt_type, knowledge_prompts,
                              response_prompt)
            _, token_lists, _ = generate(
                model, params, tokenizer, [raw],
                tokens_to_generate=args.out_seq_length,
                top_k=1, greedy=True,
            )
            # slice at the prompt TOKEN length — text-level slicing breaks
            # when detokenize(tokenize(raw)) != raw (SentencePiece BOS /
            # whitespace normalization)
            prompt_len = len(tokenizer.tokenize(raw))
            completion = tokenizer.detokenize(token_lists[0][prompt_len:])
            fout.write(postprocess_generation(completion) + "\n")
            if (i + 1) % 100 == 0:
                print(f" > generated {i + 1} samples", flush=True)
    print(f" > wrote generations to {out_path}", flush=True)


def main(args, tokenizer):
    from megatron_llm_torch.tasks.model_utils import gpt_model_and_params

    model, params = gpt_model_and_params(
        args, "prompting a randomly initialized model")
    generate_samples_by_prompting_input_from_file(model, params, tokenizer,
                                                  args)
