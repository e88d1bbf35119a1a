"""The port's copies of the tasks' pure-numpy modules
(``megatron_llm_torch/tasks/``: data_utils, GLUE and RACE datasets, the
zero-shot datasets and detokenizer, ORQA's answer matching, MSDP's
metrics, preprocessing and prompt building) against the root package's,
on the fixtures of ``tests/test_tasks.py`` and ``tests/test_msdp.py``:
every output equal exactly."""

import json

import numpy as np

import tasks.data_utils as j_du
import tasks.glue.mnli as j_mnli
import tasks.glue.qqp as j_qqp
import tasks.msdp.evaluate as j_meval
import tasks.msdp.metrics as j_metrics
import tasks.msdp.preprocessing as j_prep
import tasks.msdp.prompt as j_prompt
import tasks.orqa.evaluate_orqa as j_orqa
import tasks.race.data as j_race
import tasks.zeroshot_gpt.datasets as j_ds
import tasks.zeroshot_gpt.detokenizer as j_detok
import megatron_llm_torch.tasks.data_utils as p_du
import megatron_llm_torch.tasks.glue.mnli as p_mnli
import megatron_llm_torch.tasks.glue.qqp as p_qqp
import megatron_llm_torch.tasks.msdp.evaluate as p_meval
import megatron_llm_torch.tasks.msdp.metrics as p_metrics
import megatron_llm_torch.tasks.msdp.preprocessing as p_prep
import megatron_llm_torch.tasks.msdp.prompt as p_prompt
import megatron_llm_torch.tasks.orqa.evaluate_orqa as p_orqa
import megatron_llm_torch.tasks.race.data as p_race
import megatron_llm_torch.tasks.zeroshot_gpt.datasets as p_ds
import megatron_llm_torch.tasks.zeroshot_gpt.detokenizer as p_detok


class IntTok:
    """Whitespace-int tokenizer (tests/test_tasks.py's)."""
    cls, sep, pad, mask, eod = 1, 2, 0, 3, 2

    def tokenize(self, text):
        return [int(t) % 400 + 5 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def _same(a, b):
    """Exact equality of nested dicts / lists / tuples / arrays,
    dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic))
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def test_data_utils_match():
    for text in ("  a\t b \n c  ", "x\x00y", "plain"):
        _same(p_du.clean_text(text), j_du.clean_text(text))
    for b_len, limit in ((6, 12), (None, 7), (3, 4)):
        a = list(range(20 if b_len is None else 10))
        b = None if b_len is None else list(range(b_len))
        a2, b2 = list(a), (None if b is None else list(b))
        j_du.truncate_pair(a, b, limit)
        p_du.truncate_pair(a2, b2, limit)
        _same((a2, b2), (a, b))
    for ids_b in ([20, 21, 22], None, list(range(30, 45))):
        got = p_du.build_tokens_types_paddings_from_ids(
            [10, 11], ids_b, 12, cls_id=1, sep_id=2, pad_id=0)
        want = j_du.build_tokens_types_paddings_from_ids(
            [10, 11], ids_b, 12, cls_id=1, sep_id=2, pad_id=0)
        _same(got, want)
        _same(p_du.build_sample(*got, 2, 7), j_du.build_sample(*want, 2, 7))
    _same(p_du.build_tokens_types_paddings_from_text("3 4 5", "6 7",
                                                     IntTok(), 10),
          j_du.build_tokens_types_paddings_from_text("3 4 5", "6 7",
                                                     IntTok(), 10))


def _mnli_tsv(p):
    with open(p, "w") as f:
        f.write("\t".join(["index"] + ["c"] * 7
                          + ["sentence1", "sentence2", "gold_label"]) + "\n")
        f.write("\t".join(["0"] + ["x"] * 7
                          + ["10 11 12", "20 21", "entailment"]) + "\n")
        f.write("\t".join(["1"] + ["x"] * 7
                          + ["30 31", "40", "neutral"]) + "\n")


def _qqp_tsv(p):
    with open(p, "w") as f:
        f.write("id\tqid1\tqid2\tquestion1\tquestion2\tis_duplicate\n")
        f.write("0\ta\tb\t10 11\t12 13\t1\n")
        f.write("1\ta\tb\t14\t15 16\t0\n")
        f.write("bad row\n")  # malformed: dropped


def _race_dir(d):
    d.mkdir()
    with open(d / "doc.txt", "w") as f:
        f.write(json.dumps({
            "article": "10 11 12 13",
            "questions": ["20 _ 21", "22 23"],
            "options": [["30", "31", "32", "33"], ["40", "41", "42", "43"]],
            "answers": ["B", "D"],
        }) + "\n")


def test_glue_and_race_datasets_match(tmp_path, capsys):
    _mnli_tsv(tmp_path / "dev.tsv")
    _qqp_tsv(tmp_path / "train.tsv")
    _race_dir(tmp_path / "race")
    for jmod, pmod, cls, path, seq in (
            (j_mnli, p_mnli, "MNLIDataset", "dev.tsv", 16),
            (j_qqp, p_qqp, "QQPDataset", "train.tsv", 16),
            (j_race, p_race, "RaceDataset", "race", 32)):
        want = getattr(jmod, cls)("d", [str(tmp_path / path)], IntTok(), seq)
        j_out = capsys.readouterr().out
        got = getattr(pmod, cls)("d", [str(tmp_path / path)], IntTok(), seq)
        assert capsys.readouterr().out == j_out
        assert len(got) == len(want) > 0
        _same(_items(got), _items(want))


def test_zeroshot_datasets_and_detokenizer_match(tmp_path):
    for overlap in (8, None, 16):
        kw = dict(seq_len=16, pad_idx=0, num_original_tokens=55,
                  num_tokenized_tokens=60, overlapping_eval=overlap)
        _same(_items(p_ds.LMDataset(list(range(100, 160)), **kw)),
              _items(j_ds.LMDataset(list(range(100, 160)), **kw)))
    p = tmp_path / "l.jsonl"
    p.write_text("\n".join(json.dumps({"text": t}) for t in (
        "10 11 12 13 14", " ".join(str(i) for i in range(40)), "7")) + "\n")
    for strict in (False, True):
        _same(_items(p_ds.LambadaDataset(str(p), 0, IntTok(), 16, strict)),
              _items(j_ds.LambadaDataset(str(p), 0, IntTok(), 16, strict)))
    for text in (" @-@ ", "a @,@ b", "( x )", "= = heading = =",
                 "x @.@ y", "he said , `` no '' ."):
        for path in ("/data/wiki.valid.tokens", "/data/lambada.jsonl",
                     "/data/ptb.txt"):
            _same(p_detok.get_detokenizer(path)(text),
                  j_detok.get_detokenizer(path)(text))
        for fn in ("ptb_detokenizer", "wikitext_detokenizer",
                   "lambada_detokenizer"):
            _same(getattr(p_detok, fn)(text), getattr(j_detok, fn)(text))


def test_orqa_matching_and_qa_pairs_match(tmp_path):
    for answers, block, match in ((["Paris"], "the capital is paris .",
                                   "string"),
                                  (["Rome"], "the capital is paris .",
                                   "string"),
                                  (["par.s"], "paris", "regex"),
                                  (["(bad"], "paris", "regex")):
        _same(p_orqa.answer_in_block(answers, block, match),
              j_orqa.answer_in_block(answers, block, match))
    qa = tmp_path / "qa.tsv"
    qa.write_text("who?\t['a', 'b']\nwhat?\tplain answer\n"
                  + json.dumps({"question": "q", "answers": ["x"]}) + "\n")
    _same(p_orqa.load_qa_pairs(str(qa)), j_orqa.load_qa_pairs(str(qa)))


def test_msdp_metrics_match(tmp_path):
    for text in ("The Cat, sat!", "A  b   c"):
        _same(p_metrics.normalize_answer(text),
              j_metrics.normalize_answer(text))
    for g, a in (("the cat sat", "a cat sat down"), ("anything", ""),
                 ("", "gold"), ("zebra", "yak")):
        _same(p_metrics.token_f1(g, a), j_metrics.token_f1(g, a))
    pairs = (["cat sat", "dog ran", "x"], ["cat sat", "", "x"])
    _same(p_metrics.F1Metric.compute_all_pairs(*pairs),
          j_metrics.F1Metric.compute_all_pairs(*pairs))
    g = tmp_path / "guess.txt"
    a = tmp_path / "answer.txt"
    g.write_text("the cat<|endoftext|>\nhello world\n")
    a.write_text("cat\nno_passages_used\n")
    _same(p_meval.evaluate_f1(str(g), str(a)),
          j_meval.evaluate_f1(str(g), str(a)))


def _wow(path):
    path.write_text(json.dumps([{
        "chosen_topic": "Cats",
        "dialog": [
            {"speaker": "0_Apprentice", "text": "tell me about cats"},
            {"speaker": "1_Wizard", "text": "cats are felines",
             "checked_sentence": {"k": "A cat is a feline."}},
            {"speaker": "0_Apprentice", "text": "cool"},
            {"speaker": "1_Wizard", "text": "indeed",
             "checked_sentence": {}},
        ],
    }]))


def test_msdp_preprocessing_and_prompts_match(tmp_path):
    """Each package writes its files into its own directory; the files
    and the prompts built from them are equal."""
    out = {}
    for name, prep, prompt in (("jax", j_prep, j_prompt),
                               ("port", p_prep, p_prompt)):
        d = tmp_path / name
        d.mkdir()
        _wow(d / "wow.json")
        n = prep.process_wow_dataset(str(d / "wow.json"), str(d / "p.tsv"),
                                     str(d / "k.txt"), str(d / "r.txt"))
        (d / "train.tsv").write_text(
            "Cats\thi [SEP] tell me about cats\tA cat is a feline.\t"
            "felines!\nDogs\thello [SEP] dogs?\tDogs bark.\twoof\n")
        (d / "test.tsv").write_text(
            "Cats\tyo [SEP] what about cats\tgold knowledge\tgold resp\n")
        (d / "gen.txt").write_text("generated knowledge\n")
        prep.build_knowledge_prompts(str(d / "train.tsv"), str(d / "kp"),
                                     n_examples=2, seed=3,
                                     test_file=str(d / "test.tsv"))
        prep.build_response_prompts(str(d / "train.tsv"), str(d / "rp"),
                                    n_examples=2, seed=3)
        prep.prepare_input_for_response_generation(
            str(d / "test.tsv"), str(d / "gen.txt"), str(d / "ri.tsv"))
        kp = prompt.read_knowledge_prompts(str(d / "kp"))
        rp = prompt.read_response_prompt(str(d / "rp"), 2)
        line = "Cats\tyo [SEP] what about cats"
        out[name] = dict(
            n=n,
            files={f: (d / f).read_text() for f in
                   ("p.tsv", "k.txt", "r.txt", "kp", "rp", "ri.tsv")},
            kp=kp, rp=rp,
            knowledge=prompt.build_input(line, "knowledge", kp, ""),
            response=prompt.build_input(line + "\tK.", "response", None, rp),
            post=[prompt.postprocess_generation(t) for t in
                  (" a\nb<|endoftext|>", "<|endoftext|>x ", "")])
    _same(out["port"], out["jax"])
