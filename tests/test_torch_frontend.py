"""The port's text frontend is an own copy of the JAX package's: for every
golden and a list of further inputs, the port's function returns the
identical string / list as the JAX package's in the same process, or raises
the same exception type with the same message (hanzi or digits through the
Chinese path without pypinyin), so the cases hold with or without the
optional dictionaries installed."""

import json
import os

import numpy as np
import pytest

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu.frontend import cn as jcn, en as jen, mixed as jmixed
from emotivoice_tpu.frontend import numbers_cn as jnum_cn, numbers_en as jnum_en
from emotivoice_tpu.frontend import segment as jseg
from emotivoice_tpu_torch.frontend import cn as pcn, en as pen, mixed as pmixed
from emotivoice_tpu_torch.frontend import numbers_cn as pnum_cn, numbers_en as pnum_en
from emotivoice_tpu_torch.frontend import segment as pseg

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "frontend_goldens.jsonl")
with open(FIXTURE, encoding="utf-8") as _f:
    GOLDENS = [json.loads(line) for line in _f if line.strip()]


def outcome(fn, *args, **kw):
    """('ok', value) or ('raised', type name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # compared, not swallowed
        return ("raised", type(e).__name__, str(e))


def same(jax_fn, port_fn, *args, **kw):
    want, got = outcome(jax_fn, *args, **kw), outcome(port_fn, *args, **kw)
    assert got == want
    return got


GOLDEN_FNS = {
    "syllables": (jcn.pinyin_to_phonemes, pcn.pinyin_to_phonemes),
    "en": (jmixed.g2p_cn_en, pmixed.g2p_cn_en),
    "hanzi": (jcn.g2p_cn, pcn.g2p_cn),
    "mixed": (jmixed.g2p_cn_en, pmixed.g2p_cn_en),
}


@pytest.mark.parametrize("entry", GOLDENS,
                         ids=[f"{e['type']}-{i}" for i, e in enumerate(GOLDENS)])
def test_golden_same_as_jax(entry):
    got = same(*GOLDEN_FNS[entry["type"]], entry["input"])
    if entry["expect"] is not None and got[0] == "ok":
        value = got[1] if isinstance(got[1], str) else " ".join(got[1])
        assert value == entry["expect"]


def _seeded_texts():
    """English, mixed-script, digit and punctuation inputs from a seed."""
    rng = np.random.RandomState(7)
    words = ["hello", "world", "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "EmotiVoice", "speech", "synthesis", "running", "through", "knight", "queue",
             "rhythm", "a", "I", "it's", "well-known", "naive", "xylophone", "OK", "TTS"]
    hanzi = ["你好", "世界", "今天天气不错", "我们", "语音合成", "一百二十三"]
    nums = ["3", "42", "1984", "3.14", "1,000", "$5.50", "21st", "100%", "2024", "007"]
    punct = [",", ".", "!", "?", ";", ":", " - ", "...", "，", "。", "！"]
    out = []
    for kind in ("en", "en_punct", "digits", "mixed", "mixed_digits"):
        for _ in range(5):
            parts = list(rng.choice(words, rng.randint(2, 9)))
            if kind != "en":
                parts.insert(rng.randint(len(parts)), str(rng.choice(punct)))
            if "digits" in kind:
                parts.insert(rng.randint(len(parts)), str(rng.choice(nums)))
            if "mixed" in kind:
                parts.insert(rng.randint(len(parts)), str(rng.choice(hanzi)))
            out.append(" ".join(parts))
    return out


TEXTS = _seeded_texts() + [
    "", " ", "Hello.", "Mr. Smith paid $3.50 on the 3rd of May 1999!", "你好，world。",
    "今天是2024年5月1日", "call 911 now", "UPPER lower MiXeD", "tab\tand\nnewline",
    "emoji 😀 stays out", "«quotes» and “curly” ones",
]
LEXICON = {"hello": ["HH", "AH0", "L", "OW1"], "world": ["W", "ER1", "L", "D"]}


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_g2p_cn_en_same_as_jax(text):
    same(jmixed.g2p_cn_en, pmixed.g2p_cn_en, text)


@pytest.mark.parametrize("text", TEXTS[:10] + TEXTS[-11:], ids=range(21))
def test_g2p_cn_en_with_lexicon_and_english_numbers_same_as_jax(text):
    same(jmixed.g2p_cn_en, pmixed.g2p_cn_en, text, LEXICON)
    same(jmixed.g2p_cn_en, pmixed.g2p_cn_en, text, LEXICON, english_numbers=True)


@pytest.mark.parametrize("text", [t for t in TEXTS if not pmixed.contains_chinese(t)][:12])
def test_get_eng_phoneme_same_as_jax(text):
    for pad in (True, False):
        same(jen.get_eng_phoneme, pen.get_eng_phoneme, text, None, pad_sos_eos=pad)
        same(jen.get_eng_phoneme, pen.get_eng_phoneme, text, LEXICON, pad_sos_eos=pad)


def test_contains_chinese_same_as_jax():
    for t in TEXTS:
        assert pmixed.contains_chinese(t) == jmixed.contains_chinese(t)


NUMBERS = ["0", "7", "10", "11", "20", "101", "110", "1000", "1001", "1010", "10000", "10001",
           "100000", "1000000", "100000000", "100000001", "123456789", "1000000000000",
           "3.14", "0.5", "10.05", "007", "-5", "1.", "12.50", "abc", ""]


@pytest.mark.parametrize("mode", ["low", "up", "rmb", "direct"])
@pytest.mark.parametrize("number", NUMBERS)
def test_an2cn_same_as_jax(number, mode):
    same(jnum_cn.an2cn, pnum_cn.an2cn, number, mode)


EN_NUMBER_TEXTS = [
    "I have 3 apples", "It costs $5.50", "It costs $1", "It costs $0.01", "£20 note",
    "the 1st, 2nd, 3rd and 4th", "the 21st century", "in 1984", "in 2005", "in 2000",
    "1,000,000 people", "pi is 3.14159", "call 911", "123456789", "1000000000000",
    "0", "10 20 30", "the 100th", "$1,234.56", "room 101", "no digits here", "",
]


@pytest.mark.parametrize("text", EN_NUMBER_TEXTS, ids=range(len(EN_NUMBER_TEXTS)))
def test_english_normalize_numbers_same_as_jax(text):
    same(jnum_en.normalize_numbers, pnum_en.normalize_numbers, text)


@pytest.mark.parametrize("n", [0, 1, 9, 10, 13, 19, 20, 21, 99, 100, 101, 999, 1000, 1984,
                               2000, 2005, 12345, 10 ** 6, 10 ** 9 + 1, 10 ** 12])
def test_number_and_ordinal_words_same_as_jax(n):
    same(jnum_en.number_to_words, pnum_en.number_to_words, n)
    same(jnum_en.ordinal_to_words, pnum_en.ordinal_to_words, n)


def test_chinese_normalize_numbers_same_as_jax():
    for t in TEXTS + ["3.5个", "2024年", "1.2.3"]:
        same(jcn.normalize_numbers, pcn.normalize_numbers, t)


SYLLABLES = ["ni3", "hao3", "zhi1", "chi2", "shi4", "ri4", "zi4", "ci2", "si1", "yi1", "yu2",
             "yuan2", "yue4", "yun2", "ya1", "yong1", "you2", "wu3", "wo3", "wei2", "weng1",
             "ju1", "qu2", "xu3", "xue2", "hui4", "liu2", "lun2", "lve4", "er2", "huar1",
             "wanr2", "n2", "ng4", "m2", "a1", "o2", "e4", "ang1", "lv3", "nv3", "zhuang1",
             "ni", "", "hello", "x9"]


@pytest.mark.parametrize("syllable", SYLLABLES)
def test_split_pinyin_same_as_jax(syllable):
    same(jcn.split_pinyin, pcn.split_pinyin, syllable)


def test_pinyin_to_phonemes_with_punctuation_same_as_jax():
    for seq in (["ni3", "hao3", "，", "shi4", "jie4", "。"], ["。"], [], ["a1", "!", "?"]):
        same(jcn.pinyin_to_phonemes, pcn.pinyin_to_phonemes, seq)


RULE_WORDS = ["hello", "world", "make", "time", "knight", "phone", "queue", "rhythm", "through",
              "church", "ship", "thing", "judge", "xylophone", "a", "I", "boat", "rain", "cue",
              "naive", "it's", "well-known", "TTS", "zzz", "", "cafe", "bottle", "action"]


@pytest.mark.parametrize("word", RULE_WORDS)
def test_rule_and_fallback_g2p_same_as_jax(word):
    same(jen.rule_g2p, pen.rule_g2p, word)
    same(jen.fallback_g2p, pen.fallback_g2p, word)


def test_read_lexicon_same_as_jax(tmp_path):
    path = tmp_path / "lexicon.txt"
    path.write_text("HELLO HH AH0 L OW1\nHELLO(2) HH EH0 L OW1\nworld\tW ER1 L D\n\n"
                    "it's IH1 T S\n", encoding="utf-8")
    got = same(jen.read_lexicon, pen.read_lexicon, str(path))
    assert got[0] == "ok" and got[1]
    lex = got[1]
    same(jmixed.g2p_cn_en, pmixed.g2p_cn_en, "Hello world, it's me", lex)


PARAGRAPHS = [
    "", "Hello world.", "你好。世界！How are you? Fine.", "a. b. c. d.",
    "x" * 50 + "," + "y" * 50, "x" * 300, "One sentence. Two sentence. Three sentence.",
    "No terminal punctuation at all " * 8,
    "第一句很长很长很长很长很长很长很长很长很长很长，第二部分也很长很长很长很长很长很长；第三部分。结束！",
    "Wait... what?! Really?? Yes!!! " * 5, "A:b;c,d " * 30, "   leading and trailing   ",
    "Mixed 中文 and English。Then more English! 然后是中文？" * 3,
]


@pytest.mark.parametrize("max_chars", [6, 60, 120])
@pytest.mark.parametrize("text", PARAGRAPHS, ids=range(len(PARAGRAPHS)))
def test_split_sentences_same_as_jax(text, max_chars):
    same(jseg.split_sentences, pseg.split_sentences, text, max_chars)


def test_optional_dependencies_seen_alike():
    """The copy looks for jieba / pypinyin / g2p_en exactly as the JAX
    package does."""
    assert pcn._HAS_JIEBA == jcn._HAS_JIEBA
    assert pcn._HAS_PYPINYIN == jcn._HAS_PYPINYIN
    assert pen._HAS_G2P_EN == jen._HAS_G2P_EN


def test_hanzi_without_pypinyin_raises_g2ps_message():
    if pcn._HAS_PYPINYIN:
        assert pcn.g2p_cn("你好").startswith("<sos/eos>")
        return
    with pytest.raises(RuntimeError) as port:
        pmixed.g2p_cn_en("你好")
    with pytest.raises(RuntimeError) as ref:
        jmixed.g2p_cn_en("你好")
    assert str(port.value) == str(ref.value) and "pypinyin" in str(port.value)
