"""Record or check the frontend's golden fixture,
`tests/fixtures/frontend_goldens.jsonl`, with the port's frontend
(counterpart of `tools/record_frontend_goldens.py`; the same cases and the
same fixture).

  python -m emotivoice_tpu_torch.tools.record_frontend_goldens [--check]

The fixture is a byte-level regression corpus for the g2p frontend
(reference behaviour: `frontend_cn.py:23-121`, `frontend.py:22-64`). Entry
types:

  {"type": "syllables", "input": [TONE3 syllables], "expect": "ph ph ..."}
      the pinyin rule engine (`pinyin_to_phonemes`), runnable anywhere;
  {"type": "en", "input": text, "expect": "..."}
      English g2p through the bundled lexicon / letter-to-sound rules;
  {"type": "hanzi" | "mixed", "input": text, "expect": str | null}
      full `g2p_cn` / `g2p_cn_en`, which need jieba and pypinyin; without
      them `expect` stays as recorded (null until a host with them records).

--check compares the port's outputs with the fixture and writes nothing;
without it the fixture is rewritten, keeping expectations this host cannot
reproduce.
"""

from __future__ import annotations

import argparse
import json
import os

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "fixtures", "frontend_goldens.jsonl",
)

# Pinyin rule-engine corpus: every split_pinyin branch (zi/ci/si/ri -> ii,
# zhi/chi/shi -> iii, y/w rewrites, jqx+u -> v, ui/iu/un/ue expansions,
# syllabic nasals, erhua, all 5 tones) plus common syllables.
SYLLABLE_CASES = [
    ["ni3", "hao3"],
    ["zhong1", "guo2"],
    ["zi4", "ci2", "si1", "ri4"],
    ["zhi1", "chi2", "shi4"],
    ["yi1", "yin2", "ying3"],
    ["ya1", "yan2", "yang3", "yao4", "ye5", "yong1", "you2"],
    ["yu2", "yuan2", "yue4", "yun2"],
    ["wu3", "wo3", "wai4", "wei2", "wan2", "wen4", "wang2", "weng1"],
    ["ju1", "qu2", "xu3", "jun1", "quan2", "xue2"],
    ["hui4", "liu2", "lun2", "lve4", "jue2"],
    ["dui4", "niu2", "gun4", "nve4"],
    ["er2", "er4"],
    ["huar1", "wanr2", "dianr3"],
    ["n2", "ng5", "m5"],
    ["ma1", "ma2", "ma3", "ma4", "ma5"],
    ["bo1", "po2", "mo2", "fo2"],
    ["de5", "te4", "ne5", "le5"],
    ["ge1", "ke3", "he2"],
    ["zhuang1", "chuang2", "shuang1"],
    ["xian1", "qiang2", "jiong3"],
    ["zei2", "cao3", "sou1"],
    ["ban1", "pang2", "meng4", "feng1"],
    ["dia3", "nia1"],
    ["zhuai1", "shuai4", "guai3", "kuai4"],
    ["qiong2", "xiong2"],
    ["lv3", "nv3"],
]

# English sentences: bundled lexicon + rule-LTS fallback (frontend/en.py),
# punctuation gaps (engsp4) and word gaps (engsp1).
EN_CASES = [
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "How are you today?",
    "Speech synthesis, at last!",
    "I have twelve apples and one pear.",
]

# Chinese / mixed texts (recorded only where pypinyin+jieba exist).
HANZI_CASES = [
    "你好",
    "今天天气很好。",
    "我们一起学习语音合成。",
    "他在2023年去了北京。",
    "这是一个测试句子，包含标点符号！",
    "千山鸟飞绝，万径人踪灭。",
    "小明有3个苹果和12个橘子。",
]
MIXED_CASES = [
    "我们用Python做TTS。",
    "EmotiVoice是一个语音合成系统。",
    "请打开App然后点击开始。",
    "hello你好world世界",
]


def _record():
    from emotivoice_tpu_torch.frontend.cn import g2p_cn, pinyin_to_phonemes
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en

    entries = [{"type": "syllables", "input": syls,
                "expect": " ".join(pinyin_to_phonemes(syls))} for syls in SYLLABLE_CASES]
    entries += [{"type": "en", "input": text, "expect": g2p_cn_en(text)} for text in EN_CASES]
    try:
        import jieba  # noqa: F401
        import pypinyin  # noqa: F401

        cn_ok = True
    except ImportError:
        cn_ok = False
    entries += [{"type": "hanzi", "input": text, "expect": g2p_cn(text) if cn_ok else None}
                for text in HANZI_CASES]
    entries += [{"type": "mixed", "input": text, "expect": g2p_cn_en(text) if cn_ok else None}
                for text in MIXED_CASES]
    return entries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="compare with the fixture instead of rewriting it")
    args = ap.parse_args(argv)

    new = _record()
    if args.check:
        with open(FIXTURE, encoding="utf-8") as f:
            old = [json.loads(line) for line in f if line.strip()]
        if len(old) != len(new):
            raise AssertionError(f"the fixture has {len(old)} entries, the cases {len(new)}")
        n_checked = n_skipped = 0
        for o, n in zip(old, new):
            if (o["type"], o["input"]) != (n["type"], n["input"]):
                raise AssertionError(f"fixture entry {o} is not the case {n}")
            if n["expect"] is None or o["expect"] is None:
                n_skipped += 1
                continue
            if o["expect"] != n["expect"]:
                raise AssertionError(f"frontend output changed: {o} -> {n}")
            n_checked += 1
        print(f"OK: {n_checked} byte-exact, {n_skipped} unrecordable here")
        return {"checked": n_checked, "skipped": n_skipped}

    # keep expectations recorded where this host cannot reproduce them
    if os.path.exists(FIXTURE):
        with open(FIXTURE, encoding="utf-8") as f:
            old = {(e["type"], json.dumps(e["input"], ensure_ascii=False)): e
                   for e in (json.loads(line) for line in f if line.strip())}
        for e in new:
            key = (e["type"], json.dumps(e["input"], ensure_ascii=False))
            if e["expect"] is None and key in old:
                e["expect"] = old[key]["expect"]
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w", encoding="utf-8") as f:
        for e in new:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")
    print(f"wrote {len(new)} entries to {FIXTURE}")
    return {"written": len(new)}


if __name__ == "__main__":
    main()
