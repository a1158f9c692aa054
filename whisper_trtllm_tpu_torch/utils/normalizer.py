"""Self-contained English ASR text normalizer (the port's own copy of
``whisper_trtllm_tpu/utils/normalizer.py``: the port imports nothing of the
JAX package, and this module is pure Python).

The WER protocol normalizes both hypothesis and reference with OpenAI
Whisper's ``EnglishTextNormalizer`` before computing WER; leaderboard
numbers are not comparable without it. That package isn't importable
offline, so the full rule set is implemented here from its published
specification — lowercase, bracket/filler removal, contraction and title
expansion, spelled-number → digit conversion, British→American spelling,
symbol/diacritic stripping. ``tests/test_torch_utils.py`` holds it equal to
the JAX package's on that package's golden pairs and on a seeded fuzz
battery.

Layout:
  * :func:`strip_symbols_and_diacritics` — character-class cleanup.
  * :class:`NumberParser` / :func:`normalize_numbers` — a token-stream state
    machine converting spelled-out numbers ("one hundred and seventy-two
    thousand") to digits, keeping ordinal/plural suffixes, currency and
    percent symbols, decimals, and nominal digit strings ("one oh one").
  * :data:`UK_TO_US` — British→American spelling table, generated from base
    word groups + inflection expansion.
  * :class:`EnglishTextNormalizer` — the full pipeline.
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Tuple, Union

# --------------------------------------------------------------------------
# character-level cleanup
# --------------------------------------------------------------------------

# letters whose NFKD decomposition doesn't reach ASCII on its own
_LETTER_FOLDS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def strip_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD-decompose, drop combining marks, fold special letters, and turn
    every other mark/symbol/punctuation character into a space."""
    out: List[str] = []
    for ch in unicodedata.normalize("NFKD", s):
        if ch in keep:
            out.append(ch)
        elif ch in _LETTER_FOLDS:
            out.append(_LETTER_FOLDS[ch])
        else:
            cat = unicodedata.category(ch)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else ch)
    return "".join(out)


# --------------------------------------------------------------------------
# spelled-out numbers -> digits
# --------------------------------------------------------------------------

_ZERO_WORDS = frozenset({"o", "oh", "zero"})
_ONES_NAMES = (
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
)
_ONES = {w: i for i, w in enumerate(_ONES_NAMES, start=1)}
_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
         "seventy": 70, "eighty": 80, "ninety": 90}
_MULTIPLIERS = {
    "hundred": 10 ** 2, "thousand": 10 ** 3, "million": 10 ** 6,
    "billion": 10 ** 9, "trillion": 10 ** 12, "quadrillion": 10 ** 15,
    "quintillion": 10 ** 18, "sextillion": 10 ** 21, "septillion": 10 ** 24,
    "octillion": 10 ** 27, "nonillion": 10 ** 30, "decillion": 10 ** 33,
}


def _irregular_ordinals() -> Dict[str, Tuple[int, str]]:
    return {"zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th")}


def _build_suffixed() -> Tuple[Dict, Dict, Dict]:
    """Plural/ordinal word forms: word -> (value, printed suffix)."""
    ones_sfx: Dict[str, Tuple[int, str]] = _irregular_ordinals()
    for w, v in _ONES.items():
        if v > 3 and v not in (5, 12):
            # eight->eighth, others append 'th'
            ones_sfx[w + ("h" if w.endswith("t") else "th")] = (v, "th")
    for w, v in _ONES.items():
        ones_sfx[("sixes" if w == "six" else w + "s")] = (v, "s")
    tens_sfx = {}
    for w, v in _TENS.items():
        tens_sfx[w[:-1] + "ies"] = (v, "s")
        tens_sfx[w[:-1] + "ieth"] = (v, "th")
    mult_sfx = {}
    for w, v in _MULTIPLIERS.items():
        mult_sfx[w + "s"] = (v, "s")
        mult_sfx[w + "th"] = (v, "th")
    return ones_sfx, tens_sfx, mult_sfx


_ONES_SFX, _TENS_SFX, _MULT_SFX = _build_suffixed()

_SIGN_WORDS = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
_CURRENCY_WORDS = {"pound": "£", "pounds": "£", "euro": "€", "euros": "€",
                   "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢"}
_PREFIX_CHARS = frozenset(_SIGN_WORDS.values()) | frozenset(
    _CURRENCY_WORDS.values())
_DECIMAL_WORDS = frozenset(_ONES) | frozenset(_TENS) | _ZERO_WORDS
_SPECIAL_WORDS = frozenset({"and", "double", "triple", "point"})
_NUMBER_VOCAB = (
    _ZERO_WORDS | frozenset(_ONES) | frozenset(_ONES_SFX) | frozenset(_TENS)
    | frozenset(_TENS_SFX) | frozenset(_MULTIPLIERS) | frozenset(_MULT_SFX)
    | frozenset(_SIGN_WORDS) | frozenset(_CURRENCY_WORDS)
    | frozenset({"per", "percent"}) | _SPECIAL_WORDS)

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


class NumberParser:
    """Streaming state machine over whitespace tokens.

    The accumulator deliberately lives in one of two regimes, because the
    protocol distinguishes them: an ``int`` while the phrase composes
    arithmetically ("four hundred twenty" = 400+20), or a digit ``str`` once
    it becomes nominal (leading zeros, decimals, digit concatenation —
    "one oh one" -> "101"). A pending prefix character (sign or currency)
    attaches to the next emission.
    """

    def __init__(self) -> None:
        self._acc: Optional[Union[int, str]] = None
        self._prefix: Optional[str] = None
        self._out: List[str] = []

    # -- emission helpers ---------------------------------------------------
    def _emit(self, piece: Union[int, str]) -> None:
        text = str(piece)
        if self._prefix is not None:
            text = self._prefix + text
        self._prefix = None
        self._acc = None
        self._out.append(text)

    def _flush(self) -> None:
        if self._acc is not None:
            self._emit(self._acc)

    # -- per-category transitions -------------------------------------------
    def _merge_small(self, n: int, slot: int, prev: str) -> Union[int, str]:
        """Fold an ones-word (value ``n``, place ``slot``: 10 for digits,
        100 for teens) into the accumulator, switching to the nominal string
        regime when the phrase stops being positional."""
        acc = self._acc
        if acc is None:
            return n
        if isinstance(acc, str) or prev in _ONES:
            if prev in _TENS and n < 10:
                return acc[:-1] + str(n)  # twenty + one: fill the zero
            return str(acc) + str(n)
        if acc % slot == 0:
            return acc + n
        return str(acc) + str(n)

    def _merge_tens(self, t: int) -> Union[int, str]:
        acc = self._acc
        if acc is None:
            return t
        if isinstance(acc, str):
            return str(acc) + str(t)
        return acc + t if acc % 100 == 0 else str(acc) + str(t)

    def _apply_multiplier(self, m: int) -> Optional[Union[int, str]]:
        """Returns the new accumulator, or None if the current one had to be
        flushed first (non-numeric string regime)."""
        acc = self._acc
        if acc is None:
            return m
        if isinstance(acc, str) or acc == 0:
            try:
                frac = Fraction(acc)
            except ValueError:
                frac = None
            if frac is not None and (frac * m).denominator == 1:
                return (frac * m).numerator
            self._flush()
            return m
        return (acc // 1000) * 1000 + (acc % 1000) * m

    # -- the parse loop ------------------------------------------------------
    def run(self, words: List[str]) -> List[str]:
        skip_next = False
        for i, cur in enumerate(words):
            if skip_next:
                skip_next = False
                continue
            prev = words[i - 1] if i > 0 else ""
            nxt = words[i + 1] if i + 1 < len(words) else ""
            nxt_numeric = bool(_NUMERIC_RE.match(nxt))

            has_prefix = bool(cur) and cur[0] in _PREFIX_CHARS
            bare = cur[1:] if has_prefix else cur

            if _NUMERIC_RE.match(bare):
                # a literal number, maybe signed/currency-prefixed
                if isinstance(self._acc, str) and self._acc.endswith("."):
                    self._acc += str(cur)  # decimal / dotted-sequence tail
                    continue
                self._flush()
                if has_prefix:
                    self._prefix = cur[0]
                frac = Fraction(bare)
                self._acc = frac.numerator if frac.denominator == 1 else bare
            elif cur not in _NUMBER_VOCAB:
                self._flush()
                self._emit(cur)
            elif cur in _ZERO_WORDS:
                # NB `or ""`: an int 0 accumulator restarts the digit string
                # (protocol quirk, kept for exactness)
                self._acc = str(self._acc or "") + "0"
            elif cur in _ONES:
                n = _ONES[cur]
                self._acc = self._merge_small(n, 10 if n < 10 else 100, prev)
            elif cur in _ONES_SFX:
                n, sfx = _ONES_SFX[cur]
                merged = self._merge_small(n, 10 if n < 10 else 100, prev)
                self._emit(str(merged) + sfx)
            elif cur in _TENS:
                self._acc = self._merge_tens(_TENS[cur])
            elif cur in _TENS_SFX:
                t, sfx = _TENS_SFX[cur]
                self._emit(str(self._merge_tens(t)) + sfx)
            elif cur in _MULTIPLIERS:
                self._acc = self._apply_multiplier(_MULTIPLIERS[cur])
            elif cur in _MULT_SFX:
                m, sfx = _MULT_SFX[cur]
                if self._acc is None:
                    self._emit(str(m) + sfx)
                elif isinstance(self._acc, str):
                    try:
                        frac = Fraction(self._acc)
                    except ValueError:
                        frac = None
                    if frac is not None and (frac * m).denominator == 1:
                        self._emit(str((frac * m).numerator) + sfx)
                    else:
                        self._flush()
                        self._emit(str(m) + sfx)
                else:
                    self._emit(str((self._acc // 1000) * 1000
                                   + (self._acc % 1000) * m) + sfx)
            elif cur in _SIGN_WORDS:
                self._flush()
                if nxt in _NUMBER_VOCAB or nxt_numeric:
                    self._prefix = _SIGN_WORDS[cur]
                else:
                    self._emit(cur)
            elif cur in _CURRENCY_WORDS:
                if self._acc is not None:
                    self._prefix = _CURRENCY_WORDS[cur]
                    self._flush()
                else:
                    self._emit(cur)
            elif cur == "percent" or cur == "per":
                if self._acc is None:
                    self._emit(cur)
                elif cur == "percent":
                    self._emit(str(self._acc) + "%")
                elif nxt == "cent":
                    self._emit(str(self._acc) + "%")
                    skip_next = True
                else:
                    self._flush()
                    self._emit(cur)
            elif cur in _SPECIAL_WORDS:
                if nxt not in _NUMBER_VOCAB and not nxt_numeric:
                    self._flush()
                    self._emit(cur)
                elif cur == "and":
                    if prev not in _MULTIPLIERS:  # "hundred and five" glue
                        self._flush()
                        self._emit(cur)
                elif cur in ("double", "triple"):
                    if nxt in _ONES or nxt in _ZERO_WORDS:
                        digit = str(_ONES.get(nxt, 0))
                        reps = 2 if cur == "double" else 3
                        self._acc = str(self._acc or "") + digit * reps
                        skip_next = True
                    else:
                        self._flush()
                        self._emit(cur)
                elif cur == "point":
                    if nxt in _DECIMAL_WORDS or nxt_numeric:
                        self._acc = str(self._acc or "") + "."
        self._flush()
        return self._out


_HALF_RE = re.compile(r"\band\s+a\s+half\b")
_LETTER_DIGIT_RE = re.compile(r"([a-z])([0-9])")
_DIGIT_LETTER_RE = re.compile(r"([0-9])([a-z])")
_SUFFIX_SPACE_RE = re.compile(r"([0-9])\s+(st|nd|rd|th|s)\b")
_CENTS_RE = re.compile(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b")
# NB: the '.' is the protocol's own (unescaped) pattern — kept verbatim
_SUBDOLLAR_RE = re.compile(r"[€£$]0.([0-9]{1,2})\b")
_LITERAL_ONE_RE = re.compile(r"\b1(s?)\b")


def normalize_numbers(s: str) -> str:
    """Full number pass: 'and a half' rewriting, digit/letter splitting,
    the token state machine, then currency/cents stitching."""
    # "<number> and a half" -> "<number> point five" when it reads as one
    pieces = _HALF_RE.split(s)
    rebuilt: List[str] = []
    for i, piece in enumerate(pieces):
        if not piece.strip():
            continue
        rebuilt.append(piece)
        if i < len(pieces) - 1:
            last = piece.rsplit(maxsplit=2)[-1]
            rebuilt.append("point five"
                           if last in _DECIMAL_WORDS or last in _MULTIPLIERS
                           else "and a half")
    s = " ".join(rebuilt)
    s = _LETTER_DIGIT_RE.sub(r"\1 \2", s)
    s = _DIGIT_LETTER_RE.sub(r"\1 \2", s)
    s = _SUFFIX_SPACE_RE.sub(r"\1\2", s)

    s = " ".join(NumberParser().run(s.split()))

    def _join_cents(m: re.Match) -> str:
        try:
            return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
        except ValueError:
            return m.string

    def _cents_only(m: re.Match) -> str:
        try:
            return f"¢{int(m.group(1))}"
        except ValueError:
            return m.string

    s = _CENTS_RE.sub(_join_cents, s)       # "$2 and ¢7" -> "$2.07"
    s = _SUBDOLLAR_RE.sub(_cents_only, s)   # "$0.39"     -> "¢39"
    s = _LITERAL_ONE_RE.sub(r"one\1", s)    # bare 1/1s stay words
    return s


# --------------------------------------------------------------------------
# British -> American spelling
# --------------------------------------------------------------------------

def _inflect(base_pairs: Iterable[Tuple[str, str]],
             suffixes: Iterable[Tuple[str, str]]) -> Dict[str, str]:
    table = {}
    for uk, us in base_pairs:
        for uk_sfx, us_sfx in suffixes:
            table[uk + uk_sfx] = us + us_sfx
    return table


def _build_spelling_table() -> Dict[str, str]:
    t: Dict[str, str] = {}

    # -our -> -or
    our_words = [
        "arbour", "ardour", "armour", "behaviour", "belabour", "candour",
        "clamour", "clangour", "colour", "demeanour", "enamour", "endeavour",
        "favour", "fervour", "flavour", "glamour", "harbour", "honour",
        "humour", "labour", "misdemeanour", "neighbour", "odour", "parlour",
        "rancour", "rigour", "rumour", "saviour", "savour", "splendour",
        "succour", "tumour", "valour", "vapour", "vigour",
    ]
    t.update(_inflect(((w, w[:-3] + "or") for w in our_words),
                      [("", ""), ("s", "s"), ("ed", "ed"), ("ing", "ing"),
                       ("ite", "ite"), ("ites", "ites"), ("able", "able"),
                       ("ful", "ful"), ("less", "less")]))

    # -re -> -er
    re_words = [
        "calibre", "centre", "fibre", "goitre", "litre", "louvre", "lustre",
        "meagre", "metre", "mitre", "nitre", "ochre", "reconnoitre", "sabre",
        "saltpetre", "sceptre", "sepulchre", "sombre", "spectre", "theatre",
        "amphitheatre",
    ]
    t.update(_inflect(((w, w[:-2] + "er") for w in re_words),
                      [("", ""), ("s", "s"), ("d", "ed")]))
    t["centring"] = "centering"
    t["manoeuvre"] = "maneuver"
    t["manoeuvres"] = "maneuvers"
    t["manoeuvred"] = "maneuvered"
    t["manoeuvring"] = "maneuvering"

    # -ise -> -ize verb family (+ derived -isation/-iser)
    ise_verbs = [
        "agonise", "apologise", "authorise", "baptise", "capitalise",
        "categorise", "centralise", "characterise", "civilise", "colonise",
        "criticise", "customise", "demonise", "dramatise", "economise",
        "emphasise", "energise", "equalise", "familiarise", "fertilise",
        "finalise", "fraternise", "generalise", "harmonise", "hospitalise",
        "hypnotise", "idealise", "idolise", "immunise", "immortalise",
        "italicise", "jeopardise", "legalise", "liberalise", "localise",
        "magnetise", "materialise", "maximise", "mechanise", "memorialise",
        "memorise", "mesmerise", "minimise", "mobilise", "modernise",
        "monopolise", "moralise", "nationalise", "naturalise", "neutralise",
        "normalise", "optimise", "organise", "ostracise", "patronise",
        "penalise", "personalise", "philosophise", "plagiarise", "polarise",
        "popularise", "pressurise", "prioritise", "privatise", "publicise",
        "pulverise", "randomise", "rationalise", "realise", "recognise",
        "reorganise", "revolutionise", "satirise", "scandalise",
        "scrutinise", "sensitise", "serialise", "socialise", "specialise",
        "stabilise", "standardise", "sterilise", "stigmatise", "subsidise",
        "summarise", "symbolise", "sympathise", "synchronise", "synthesise",
        "systematise", "tantalise", "terrorise", "theorise", "tranquillise",
        "trivialise", "tyrannise", "urbanise", "utilise", "vandalise",
        "vaporise", "verbalise", "victimise", "visualise", "vocalise",
        "vulgarise",
    ]
    for uk in ise_verbs:
        stem = uk[:-3]
        t[f"{stem}ise"] = f"{stem}ize"
        t[f"{stem}ises"] = f"{stem}izes"
        t[f"{stem}ised"] = f"{stem}ized"
        t[f"{stem}ising"] = f"{stem}izing"
        t[f"{stem}iser"] = f"{stem}izer"
        t[f"{stem}isers"] = f"{stem}izers"
        t[f"{stem}isation"] = f"{stem}ization"
        t[f"{stem}isations"] = f"{stem}izations"

    # -yse -> -yze
    for uk in ("analyse", "breathalyse", "catalyse", "electrolyse",
               "paralyse"):
        stem = uk[:-3]
        t[f"{stem}yse"] = f"{stem}yze"
        t[f"{stem}yses"] = f"{stem}yzes"
        t[f"{stem}ysed"] = f"{stem}yzed"
        t[f"{stem}ysing"] = f"{stem}yzing"
        t[f"{stem}yser"] = f"{stem}yzer"
        t[f"{stem}ysers"] = f"{stem}yzers"

    # single -l- before suffix (travelled -> traveled)
    l_verbs = [
        "cancel", "channel", "chisel", "counsel", "dial", "duel", "equal",
        "fuel", "funnel", "gambol", "grovel", "jewel", "kennel", "label",
        "level", "libel", "marshal", "marvel", "model", "panel", "pedal",
        "pencil", "quarrel", "ravel", "revel", "rival", "shovel", "shrivel",
        "signal", "snivel", "spiral", "squirrel", "stencil", "swivel",
        "tassel", "travel", "tunnel", "unravel",
    ]
    for w in l_verbs:
        t[w + "led"] = w + "ed"
        t[w + "ling"] = w + "ing"
        t[w + "ler"] = w + "er"
        t[w + "lers"] = w + "ers"
    t.update({
        "marvellous": "marvelous", "jewellery": "jewelry",
        "woollen": "woolen", "counsellor": "counselor",
        "counsellors": "counselors",
        "traveller": "traveler", "travellers": "travelers",
    })

    # -ogue -> -og
    for w in ("analogue", "catalogue", "dialogue", "epilogue", "monologue",
              "prologue", "travelogue"):
        t[w] = w[:-2]
        t[w + "s"] = w[:-2] + "s"
    t["catalogued"] = "cataloged"
    t["cataloguing"] = "cataloging"

    # ae/oe -> e
    t.update({
        "anaemia": "anemia", "anaemic": "anemic",
        "anaesthesia": "anesthesia", "anaesthetic": "anesthetic",
        "anaesthetics": "anesthetics", "amoeba": "ameba",
        "archaeology": "archeology", "archaeologist": "archeologist",
        "archaeologists": "archeologists", "archaeological": "archeological",
        "diarrhoea": "diarrhea", "encyclopaedia": "encyclopedia",
        "encyclopaedias": "encyclopedias", "foetal": "fetal",
        "foetus": "fetus", "gynaecology": "gynecology",
        "haemoglobin": "hemoglobin", "haemorrhage": "hemorrhage",
        "leukaemia": "leukemia", "mediaeval": "medieval",
        "oesophagus": "esophagus", "oestrogen": "estrogen",
        "orthopaedic": "orthopedic", "paediatric": "pediatric",
        "paediatrician": "pediatrician",
    })

    # -ce/-se and other irregulars
    t.update({
        "defence": "defense", "defences": "defenses",
        "offence": "offense", "offences": "offenses",
        "pretence": "pretense", "pretences": "pretenses",
        "licence": "license", "licences": "licenses",
        "practise": "practice", "practised": "practiced",
        "practises": "practices", "practising": "practicing",
        "grey": "gray", "greys": "grays", "greyish": "grayish",
        "plough": "plow", "ploughs": "plows", "ploughed": "plowed",
        "ploughing": "plowing", "snowplough": "snowplow",
        "mould": "mold", "moulds": "molds", "moulded": "molded",
        "moulding": "molding", "mouldy": "moldy",
        "moult": "molt", "moulted": "molted", "smoulder": "smolder",
        "smouldering": "smoldering", "moustache": "mustache",
        "moustaches": "mustaches", "pyjamas": "pajamas",
        "tyre": "tire", "tyres": "tires", "kerb": "curb", "kerbs": "curbs",
        "cheque": "check", "cheques": "checks", "chequebook": "checkbook",
        "programme": "program", "programmes": "programs",
        "gaol": "jail", "gaols": "jails", "draught": "draft",
        "draughts": "drafts", "draughty": "drafty",
        "sceptic": "skeptic", "sceptical": "skeptical",
        "scepticism": "skepticism", "storey": "story", "storeys": "stories",
        "sulphur": "sulfur", "sulphuric": "sulfuric",
        "aluminium": "aluminum", "aeroplane": "airplane",
        "aeroplanes": "airplanes", "artefact": "artifact",
        "artefacts": "artifacts", "ageing": "aging", "axe": "ax",
        "behove": "behoove", "cosy": "cozy", "doughnut": "donut",
        "doughnuts": "donuts", "enquire": "inquire", "enquired": "inquired",
        "enquiring": "inquiring", "enquiry": "inquiry",
        "enquiries": "inquiries", "fulfil": "fulfill",
        "fulfilment": "fulfillment", "instalment": "installment",
        "instalments": "installments", "skilful": "skillful",
        "wilful": "willful", "enrol": "enroll", "enrolment": "enrollment",
        "distil": "distill", "instil": "instill", "enthral": "enthrall",
        "appal": "appall", "gramme": "gram", "grammes": "grams",
        "judgement": "judgment", "judgements": "judgments",
        "acknowledgement": "acknowledgment",
        "acknowledgements": "acknowledgments", "abridgement": "abridgment",
        "whisky": "whiskey", "omelette": "omelet", "omelettes": "omelets",
        "pedlar": "peddler", "speciality": "specialty",
        "specialities": "specialties", "titbit": "tidbit",
        "waggon": "wagon", "waggons": "wagons", "yoghurt": "yogurt",
    })
    return t


UK_TO_US: Dict[str, str] = _build_spelling_table()


def americanize(s: str) -> str:
    """Word-level British->American mapping (tysto-list families)."""
    return " ".join(UK_TO_US.get(w, w) for w in s.split())


# --------------------------------------------------------------------------
# the full pipeline
# --------------------------------------------------------------------------

_FILLERS_RE = re.compile(r"\b(hmm|mm|mhm|mmm|uh|um)\b")
_BRACKETS_RE = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENS_RE = re.compile(r"\(([^)]+?)\)")
_SPACE_APOSTROPHE_RE = re.compile(r"\s+'")
_DIGIT_COMMA_RE = re.compile(r"(\d),(\d)")
_TRAILING_PERIOD_RE = re.compile(r"\.([^0-9]|$)")
_DANGLING_PREFIX_RE = re.compile(r"[.$¢€£]([^0-9])")
_DANGLING_PERCENT_RE = re.compile(r"([^0-9])%")
_WHITESPACE_RE = re.compile(r"\s+")

# contraction/title expansions, applied in order (protocol data: the
# reference's EnglishTextNormalizer rule list)
_REWRITES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat), rep) for pat, rep in (
        (r"\bwon't\b", "will not"),
        (r"\bcan't\b", "can not"),
        (r"\blet's\b", "let us"),
        (r"\bain't\b", "aint"),
        (r"\by'all\b", "you all"),
        (r"\bwanna\b", "want to"),
        (r"\bgotta\b", "got to"),
        (r"\bgonna\b", "going to"),
        (r"\bi'ma\b", "i am going to"),
        (r"\bimma\b", "i am going to"),
        (r"\bwoulda\b", "would have"),
        (r"\bcoulda\b", "could have"),
        (r"\bshoulda\b", "should have"),
        (r"\bma'am\b", "madam"),
        (r"\bmr\b", "mister "),
        (r"\bmrs\b", "missus "),
        (r"\bst\b", "saint "),
        (r"\bdr\b", "doctor "),
        (r"\bprof\b", "professor "),
        (r"\bcapt\b", "captain "),
        (r"\bgov\b", "governor "),
        (r"\bald\b", "alderman "),
        (r"\bgen\b", "general "),
        (r"\bsen\b", "senator "),
        (r"\brep\b", "representative "),
        (r"\bpres\b", "president "),
        (r"\brev\b", "reverend "),
        (r"\bhon\b", "honorable "),
        (r"\basst\b", "assistant "),
        (r"\bassoc\b", "associate "),
        (r"\blt\b", "lieutenant "),
        (r"\bcol\b", "colonel "),
        (r"\bjr\b", "junior "),
        (r"\bsr\b", "senior "),
        (r"\besq\b", "esquire "),
        (r"'d been\b", " had been"),
        (r"'s been\b", " has been"),
        (r"'d gone\b", " had gone"),
        (r"'s gone\b", " has gone"),
        (r"'d done\b", " had done"),
        (r"'s got\b", " has got"),
        (r"n't\b", " not"),
        (r"'re\b", " are"),
        (r"'s\b", " is"),
        (r"'d\b", " would"),
        (r"'ll\b", " will"),
        (r"'t\b", " not"),
        (r"'ve\b", " have"),
        (r"'m\b", " am"),
    ))


class EnglishTextNormalizer:
    """The reference WER protocol's text normalization, self-contained
    (reference: examples/whisper/cal_wer.py:281-285 applies it to both
    hypothesis and reference before jiwer)."""

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = _BRACKETS_RE.sub("", s)
        s = _PARENS_RE.sub("", s)
        s = _FILLERS_RE.sub("", s)
        s = _SPACE_APOSTROPHE_RE.sub("'", s)
        for pattern, replacement in _REWRITES:
            s = pattern.sub(replacement, s)
        s = _DIGIT_COMMA_RE.sub(r"\1\2", s)
        s = _TRAILING_PERIOD_RE.sub(r" \1", s)
        s = strip_symbols_and_diacritics(s, keep=".%$¢€£")
        s = normalize_numbers(s)
        s = americanize(s)
        s = _DANGLING_PREFIX_RE.sub(r" \1", s)
        s = _DANGLING_PERCENT_RE.sub(r"\1 ", s)
        s = _WHITESPACE_RE.sub(" ", s)
        return s


class BasicTextNormalizer:
    """Language-agnostic variant (lowercase, bracket removal, symbol strip)
    — the protocol's multilingual fallback."""

    def __init__(self, remove_diacritics: bool = False):
        self._remove_diacritics = remove_diacritics

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = _BRACKETS_RE.sub("", s)
        s = _PARENS_RE.sub("", s)
        if self._remove_diacritics:
            s = strip_symbols_and_diacritics(s)
        else:
            s = "".join(" " if unicodedata.category(c)[0] in "MSP" else c
                        for c in unicodedata.normalize("NFKC", s))
        s = s.lower()
        s = _WHITESPACE_RE.sub(" ", s)
        return s
