"""Chinese inverse text normalization (spoken numerals -> Arabic digits).

Same capability class as the reference's chinese_itn
(qwen_asr_gguf/inference/chinese_itn.py: table/regex-driven conversion with
an idiom blacklist, measure-word context rules, unit mapping, range
expressions like 三五百人 -> 300~500人, clock times, dates and ordinals),
implemented independently. Behavior is cross-checked against the reference
module on a shared corpus (tests/test_text.py); where the reference has
clear bugs (千分之三 -> '3/0', 五十千瓦 -> '50000瓦') this module produces
the sensible output instead.

Core policy: a span is rewritten when it clearly denotes a number —
magnitude/decimal/fraction markers, digit-strings of length >= 3 (years,
phone numbers), or a single digit in a converting context (measure word,
date suffix). Idioms and ordinary prose stay untouched; the ambiguous
一/两 convert only before 号/月/日.
"""

from __future__ import annotations

import re

DIGITS = {"零": 0, "〇": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4,
          "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
SMALL_UNITS = {"十": 10, "百": 100, "千": 1000}
BIG_UNITS = {"万": 10_000, "亿": 100_000_000}

# common idioms / fixed expressions that contain numeral characters
IDIOM_BLACKLIST = {
    "一心一意", "一模一样", "一毛一样", "三心二意", "四分五裂", "乱七八糟",
    "五湖四海", "七上八下", "九牛一毛", "十全十美", "一五一十", "五花八门",
    "千方百计", "千军万马", "万无一失", "一塌糊涂", "不三不四", "说三道四",
    "丢三落四", "朝三暮四", "三言两语", "七嘴八舌", "千山万水", "万水千山",
    "五颜六色", "一帆风顺", "一举两得", "独一无二", "数一数二", "百发百中",
    "半斤八两", "三三两两", "一清二楚", "一干二净", "七零八落", "横七竖八",
    "四舍五入", "九九八十一", "一一得一", "三思而行", "五体投地", "六神无主",
    "十拿九稳", "万众一心", "千变万化", "千辛万苦", "成千上万", "千千万万",
    "一分为二", "合二为一", "接二连三", "再三再四", "低三下四", "五大三粗",
    "三头六臂", "六亲不认", "七手八脚", "八九不离十", "十万火急", "一石二鸟",
    "一箭双雕", "二话不说", "三六九等", "四面八方", "五光十色", "九死一生",
}

# measure words after which a single digit 二..九 converts (他三天 -> 3天)
MEASURE_SUFFIX = set("个天块岁名号楼层年月日米元人次回届场张只条件位本页度克吨斤秒倍台辆架间部首篇声")
# the ambiguous 一/两 convert only before unambiguous date/ordinal markers
ONE_TWO_SUFFIX = set("号月日")
# bare 十 converts only before these (十个 -> 10个 but 零下十度 stays)
TEN_SUFFIX = set("个号月日年")
# compound units: a trailing 千 in the span belongs to the unit, not the
# magnitude (三千克 = 3 kg, not 3000 克); mapped names follow the reference
# (千克 -> kg, chinese_itn.py unit tables)
UNIT_MAP = {"千克": "kg", "千米": "千米", "千瓦": "千瓦", "千卡": "千卡", "千斤": "千斤"}

_NUM = "零〇一二两三四五六七八九十百千万亿"
_D = "零〇一二两三四五六七八九"

_TIME_RE = re.compile(rf"([{_NUM}]+)点([{_NUM}]+)分(?!之)")
_SPAN_RE = re.compile(
    rf"(负?[{_NUM}]+分之[{_NUM}点]+"  # fractions 三分之二
    rf"|负?百分之[{_NUM}点]+"
    rf"|负?[{_NUM}]+(?:点[{_D}]+)?)"
    rf"([克米瓦卡斤])?"  # possible second half of a compound 千-unit
)


def _parse_cardinal(s: str) -> int | None:
    """Positional parse of 三百二十五 / 十五 / 一万零三 style numerals,
    including the trailing-shorthand forms 三千五 (=3500) / 两万三 (=23000)."""
    if not s:
        return None
    # trailing shorthand: unit followed by one closing digit means the next
    # magnitude down (一百五 = 150). 十 needs no special case (二十五 = 25).
    if len(s) >= 2 and s[-1] in DIGITS and s[-1] not in ("零", "〇") and s[-2] in "百千万亿":
        base = _parse_cardinal(s[:-1])
        if base is None:
            return None
        unit = SMALL_UNITS.get(s[-2]) or BIG_UNITS[s[-2]]
        return base + DIGITS[s[-1]] * (unit // 10)
    total = 0
    section = 0  # value below the current big unit
    current = 0  # value below the current small unit
    seen_any = False
    for ch in s:
        if ch in ("零", "〇"):
            seen_any = True  # zeros only separate positions
        elif ch in DIGITS:
            current = current * 10 + DIGITS[ch]
            seen_any = True
        elif ch in SMALL_UNITS:
            mult = SMALL_UNITS[ch]
            section += (current if current else 1) * mult
            current = 0
            seen_any = True
        elif ch in BIG_UNITS:
            mult = BIG_UNITS[ch]
            section += current
            if section == 0:
                section = 1
            total = (total + section) * mult
            section = 0
            current = 0
            seen_any = True
        else:
            return None
    if not seen_any:
        return None
    return total + section + current


def _pure_digit_string(s: str) -> str | None:
    """一九九八 -> '1998' (every char a digit incl. 零)."""
    out = []
    for ch in s:
        if ch in ("零", "〇"):
            out.append("0")
        elif ch in DIGITS and ch != "两":
            out.append(str(DIGITS[ch]))
        else:
            return None
    return "".join(out)


def _try_range(s: str, suffix: str) -> str | None:
    """Range expressions: 三五百 -> 300~500, 三四十 -> 30~40,
    十七八(岁) -> 17~18, 五六(个) -> 5~6."""
    # two adjacent digits before a magnitude unit
    if len(s) >= 3 and s[0] in DIGITS and s[1] in DIGITS and s[2] in "十百千万亿":
        lo = _parse_cardinal(s[0] + s[2:])
        hi = _parse_cardinal(s[1] + s[2:])
        if lo is not None and hi is not None and lo < hi:
            return f"{lo}~{hi}"
    # tens prefix + two consecutive digits: 十七八 / 二十七八
    if len(s) >= 3 and s[-1] in DIGITS and s[-2] in DIGITS and s[-3] == "十":
        lo = _parse_cardinal(s[:-1])
        hi = _parse_cardinal(s[:-2] + s[-1])
        if lo is not None and hi is not None and hi == lo + 1:
            return f"{lo}~{hi}"
    # two bare consecutive digits before a measure word: 五六个 -> 5~6个
    # (only unambiguous digits — 一两个/两三天 are habitual approximations
    # the reference also leaves alone)
    if len(s) == 2 and suffix in MEASURE_SUFFIX and s[0] in "三四五六七八九" and s[1] in "三四五六七八九":
        lo, hi = DIGITS[s[0]], DIGITS[s[1]]
        if hi == lo + 1:
            return f"{lo}~{hi}"
    return None


def _convert_span(s: str, prev: str, suffix: str) -> str | None:
    """Convert one numeral span given its context (`prev` = char before the
    span, `suffix` = measure word / unit right after it). None = leave."""
    neg = s.startswith("负")
    if neg:
        s = s[1:]
    prefix = "负" if neg else ""  # the reference keeps 负 as a character

    percent = s.startswith("百分之")
    if percent:
        s = s[len("百分之"):]
        if not any(c in DIGITS for c in s):
            return None  # 百分之百 stays
    elif "分之" in s:
        denom_s, _, numer_s = s.partition("分之")
        denom = _parse_cardinal(denom_s)
        numer = _parse_cardinal(numer_s)
        if denom is None or numer is None:
            return None
        return f"{prefix}{numer}/{denom}"

    # decimal part
    frac = ""
    if "点" in s:
        s, _, frac_part = s.partition("点")
        digits = _pure_digit_string(frac_part)
        if digits is None:
            return None
        frac = "." + digits

    if not percent and not frac:
        rng = _try_range(s, suffix)
        if rng is not None:
            return prefix + rng

    has_unit = any(c in s for c in "十百千万亿")
    if has_unit:
        if len(s) == 1:  # a lone magnitude char: only 十 in counting context
            if s != "十" or suffix not in TEN_SUFFIX or prev == "第":
                return None
        elif not any(c in DIGITS for c in s) and not s.startswith("十"):
            # pure-magnitude spans (千万别去, 成百上千) are rhetorical
            return None
        if s.endswith("亿") and not frac:
            # keep 亿 as a unit word: 十三亿人 -> 13亿人 (reference behavior)
            mant = _parse_cardinal(s[:-1])
            if mant is None:
                return None
            return f"{prefix}{mant}亿"
        val = _parse_cardinal(s)
        if val is None:
            return None
        out = f"{val}{frac}"
    elif frac or percent:
        val = _parse_cardinal(s) if s else 0
        if val is None:
            return None
        out = f"{val}{frac}"
    else:
        digits = _pure_digit_string(s)
        if digits is not None and (
            len(digits) >= 3 or (len(digits) == 2 and suffix in ("年", "折"))
        ):
            out = digits
        elif len(s) == 1 and prev != "第":
            # single spoken digit: converts only in a counting context
            if s in ("一", "两"):
                if suffix not in ONE_TWO_SUFFIX:
                    return None
            elif suffix not in MEASURE_SUFFIX and suffix not in UNIT_MAP:
                return None
            if s in ("零", "〇"):
                return None
            out = str(DIGITS[s])
        else:
            return None

    if percent:
        out += "%"
    return prefix + out


def _convert_time(m: re.Match) -> str:
    h = _parse_cardinal(m.group(1))
    mm = _parse_cardinal(m.group(2))
    if h is None or mm is None or not (0 <= h <= 24 and 0 <= mm <= 59):
        return m.group(0)
    return f"{h:02d}:{mm:02d}"


def chinese_to_num(text: str) -> str:
    """Rewrite spoken Chinese numerals in `text` to Arabic digits."""
    if not text:
        return text

    def guarded(m: re.Match, conv) -> str:
        start = max(0, m.start() - 4)
        context = text[start : m.end() + 4]
        for idiom in IDIOM_BLACKLIST:
            if idiom in context:
                return m.group(0)
        return conv(m)

    # clock times first: 五点十五分 -> 05:15 (the span regex would otherwise
    # see 五点十 as a malformed decimal)
    text = _TIME_RE.sub(lambda m: guarded(m, _convert_time), text)

    def repl(m: re.Match) -> str:
        span, unit_char = m.group(1), m.group(2) or ""
        prev = text[m.start() - 1] if m.start() > 0 else ""
        unit = ""
        if unit_char:
            core_wo = span[:-1] if span.endswith("千") else None
            # a trailing 千 belongs to a compound unit (三千克 = 3 kg,
            # 一百二十千米 = 120 km) unless the span carries a bigger
            # magnitude (一万五千米 = 15000 米)
            if core_wo is not None and ("千" + unit_char) in UNIT_MAP and not any(
                c in core_wo for c in "万亿"
            ):
                span, unit = core_wo, "千" + unit_char
            else:
                unit = unit_char
        suffix = unit if len(unit) == 2 else (unit_char or text[m.end() :][:1])
        out = _convert_span(span, prev, suffix)
        if out is None:
            return m.group(0)
        return out + UNIT_MAP.get(unit, unit)

    def span_repl(m: re.Match) -> str:
        return guarded(m, repl)

    return _SPAN_RE.sub(span_repl, text)
