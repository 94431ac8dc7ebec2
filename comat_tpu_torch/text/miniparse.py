"""Rule-based dependency mini-parser (spacy-compatible doc interface).

The port's own copy of comat_tpu/text/miniparse.py, unchanged but for
this paragraph; the port imports nothing of the JAX package.

The reference mines attribute-noun subtrees from a spacy
`en_core_web_trf` dependency parse (attribute_concen_utils.py:39-131;
pipeline wiring AttrConcenTrainableSDPipeline.py:69-71). That parser is
not in this image, so this module provides a deterministic rule-based
tagger + shallow dependency builder for the restricted grammar of the
training corpora (collected_data/abc5k.txt, hrs_collected_10k.txt,
merged_data/*: short declarative captions — noun phrases with
prenominal modifiers, copulas, relative clauses, prepositional
phrases).

The output duck-types the fragment of spacy's API the extraction
functions consume: a doc is a list of `Token`s, each with `.text`,
`.pos_`, `.dep_`, `.i`, `.head`, and `.children` (document order).
Dependency labels follow spacy's English scheme (amod, compound, conj,
cc, acomp, relcl, nsubj, det, prep, pobj, dobj, aux, ...) so the same
extraction code runs unchanged on a real spacy doc when one is
available (see linguistics.parse_prompt).
"""

from __future__ import annotations

from typing import List, Optional

DETERMINERS = {
    "a", "an", "the", "some", "this", "these", "those", "my", "your",
    "his", "her", "its", "their", "our", "any", "each", "every", "no",
    "another", "all", "both",
}

NUMBERS = {
    "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "dozen", "several", "many", "few",
}

AUXILIARIES = {"is", "are", "was", "were", "am", "be", "been", "being"}

COORDINATORS = {"and", "or", "but"}

PREPOSITIONS = {
    "in", "on", "at", "with", "of", "to", "from", "under", "over",
    "above", "below", "behind", "beside", "near", "inside", "outside",
    "into", "onto", "by", "for", "between", "during", "through",
    "across", "along", "around", "against", "upon", "beneath",
    "underneath", "atop", "amid", "among", "than", "off", "up", "down",
    "without", "towards", "toward", "next",
}

PRONOUNS = {
    "it", "they", "he", "she", "i", "we", "you", "someone", "something",
    "anyone", "anything", "everyone", "everything", "who", "whom",
}

ADVERBS = {"very", "too", "so", "quite", "really", "extremely", "while"}

# Attributive adjectives common in the attribute-binding corpora
# (colors / sizes / materials / states). Tagging here drives amod/acomp
# arcs, which is what the extraction subtrees are made of.
ADJECTIVES = {
    # colors
    "red", "orange", "yellow", "green", "blue", "purple", "pink",
    "brown", "black", "white", "gray", "grey", "golden", "gold",
    "silver", "beige", "tan", "cyan", "magenta", "teal", "navy",
    "maroon", "violet", "turquoise", "colorful", "colored",
    # sizes / shapes
    "big", "small", "large", "tiny", "huge", "giant", "little", "tall",
    "short", "long", "wide", "narrow", "thick", "thin", "spacious",
    "round", "square", "flat", "curved", "oval",
    # comparatives (HRS size-comparison prompts)
    "bigger", "smaller", "larger", "taller", "shorter", "longer",
    "wider", "higher", "lower", "faster", "slower",
    # materials
    "wooden", "metal", "metallic", "plastic", "glass", "leather",
    "rubber", "stone", "brick", "concrete", "steel", "ceramic",
    "fluffy", "furry", "feathered", "woolen", "cotton", "silk",
    # states / qualities
    "old", "new", "young", "clean", "dirty", "shiny", "bright", "dark",
    "beautiful", "pretty", "ugly", "happy", "sad", "cute", "fancy",
    "modern", "vintage", "rustic", "empty", "full", "open", "closed",
    "soft", "hard", "wet", "dry", "hot", "cold", "warm", "cool",
    "fresh", "ripe", "cloudy", "sunny", "rainy", "snowy", "foggy",
    "busy", "quiet", "crowded", "striped", "spotted", "checkered",
    "plaid", "floral", "transparent", "glossy", "matte", "rusty",
    "broken", "sharp", "dull", "heavy", "lightweight", "delicious",
    "tasty", "juicy", "sweet", "sour", "spicy", "frozen", "melted",
}

# Frequent corpus verbs whose surface form the morphology rules below
# would mis-tag (no -ing/-ed suffix).
VERBS = {
    "has", "have", "had", "takes", "take", "took", "sits", "sit",
    "stands", "stand", "stood", "rests", "rest", "holds", "hold",
    "held", "wears", "wear", "wore", "plays", "play", "runs", "run",
    "ran", "jumps", "jump", "flies", "fly", "flew", "eats", "eat",
    "ate", "drinks", "drink", "drank", "floats", "float", "hangs",
    "hang", "hung", "lies", "lie", "lay", "walks", "walk", "looks",
    "look", "seems", "seem", "appears", "appear", "contains",
    "contain", "features", "feature", "includes", "include", "shows",
    "show", "wags", "wag", "makes", "make", "made", "gives", "give",
    "gave", "puts", "put", "gets", "get", "got", "goes", "go", "went",
    "comes", "come", "came", "says", "say", "said", "sees", "see",
    "saw", "catches", "catch", "caught", "throws", "throw", "threw",
    "rides", "ride", "rode", "drives", "drive", "drove", "swims",
    "swim", "swam", "climbs", "climb", "bites", "bite", "bit",
    "kicks", "kick", "washes", "wash", "reads", "read", "writes",
    "write", "wrote", "draws", "draw", "drew", "paints", "paint",
    "cooks", "cook", "bakes", "bake", "cuts", "cut", "opens", "shuts",
    "shut", "closes", "close", "sleeps", "sleep", "slept", "barked",
    "wagged",
}

# Gerund-looking words that are really nouns/adjectives in captions.
ING_NOMINALS = {
    "painting", "building", "ceiling", "clothing", "lightning",
    "morning", "evening", "wedding", "string", "ring", "king", "wing",
    "thing", "spring", "swing", "living", "dining", "railing",
    "awning", "icing", "frosting", "carving",
}


class Token:
    """Minimal spacy-Token stand-in. `children` is kept in document
    order (spacy's `Token.children` iteration order)."""

    __slots__ = ("text", "pos_", "dep_", "i", "head", "_children")

    def __init__(self, text: str, pos: str, i: int):
        self.text = text
        self.pos_ = pos
        self.dep_ = "dep"
        self.i = i
        self.head: Optional["Token"] = None
        self._children: List["Token"] = []

    @property
    def children(self) -> List["Token"]:
        return sorted(self._children, key=lambda t: t.i)

    def attach(self, head: "Token", dep: str) -> None:
        self.head = head
        self.dep_ = dep
        head._children.append(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.text}/{self.pos_}/{self.dep_}"


def _tokenize(prompt: str) -> List[str]:
    out: List[str] = []
    for raw in prompt.split():
        # split leading/trailing punctuation into their own tokens
        start = 0
        end = len(raw)
        lead: List[str] = []
        while start < end and raw[start] in ".,;:!?\"'()":
            lead.append(raw[start])
            start += 1
        trail: List[str] = []
        while end > start and raw[end - 1] in ".,;:!?\"'()":
            trail.append(raw[end - 1])
            end -= 1
        out.extend(lead)
        if end > start:
            out.append(raw[start:end])
        out.extend(reversed(trail))
    return out


def _tag(words: List[str]) -> List[str]:
    tags: List[str] = []
    for idx, w in enumerate(words):
        lw = w.lower()
        if not any(c.isalnum() for c in w):
            tags.append("PUNCT")
        elif lw in ("that", "which"):
            # relativizer when following a noun-ish word and followed by
            # an aux/verb ("a dog that is red"); else determiner
            nxt = words[idx + 1].lower() if idx + 1 < len(words) else ""
            if idx > 0 and (
                nxt in AUXILIARIES or nxt in VERBS or nxt.endswith("ing")
            ):
                tags.append("PRON")
            else:
                tags.append("DET")
        elif lw in DETERMINERS:
            tags.append("DET")
        elif lw in NUMBERS or lw.isdigit():
            tags.append("NUM")
        elif lw in AUXILIARIES:
            tags.append("AUX")
        elif lw in COORDINATORS:
            tags.append("CCONJ")
        elif lw in PREPOSITIONS:
            tags.append("ADP")
        elif lw in PRONOUNS:
            tags.append("PRON")
        elif lw in ADJECTIVES:
            tags.append("ADJ")
        elif lw in ADVERBS or (lw.endswith("ly") and len(lw) > 3):
            tags.append("ADV")
        elif lw in VERBS:
            tags.append("VERB")
        elif (
            lw.endswith("ing") and len(lw) > 4 and lw not in ING_NOMINALS
        ):
            tags.append("VERB")
        elif lw.endswith("ed") and len(lw) > 4 and lw not in ADJECTIVES:
            tags.append("VERB")
        else:
            tags.append("NOUN")
    return tags


def parse(prompt: str) -> List[Token]:
    """Tag + attach dependencies. Returns the doc (list of Tokens in
    document order); tokens with no head keep dep_='dep'/'ROOT'."""
    words = _tokenize(prompt)
    tags = _tag(words)
    doc = [Token(w, t, i) for i, (w, t) in enumerate(zip(words, tags))]

    pending: List[Token] = []  # DET/NUM/ADJ/NOUN awaiting a head noun
    pending_cc: List[Token] = []  # coordinators inside `pending`
    last_head: Optional[Token] = None  # most recent closed NP head
    conj_head: Optional[Token] = None  # attach next NP as conj of this
    last_verb: Optional[Token] = None  # clause verb/aux for nsubj/dobj
    next_np_dep = "nsubj"  # dep for the next closed NP head
    next_np_head: Optional[Token] = None  # head for the next closed NP
    last_pred_adj: Optional[Token] = None  # acomp for conj chains
    relativizer: Optional[Token] = None  # pending that/which
    expect_pred = False  # directly after a copula/verb (through ADVs)
    conj_from_comma = False  # next conj arc licensed by "," not CCONJ
    comma_conj: set = set()  # NP heads conj-attached via a bare comma

    def close_np() -> Optional[Token]:
        """Resolve the pending buffer into one NP: head = last noun;
        earlier tokens attach as det/nummod/amod/compound; coordinated
        prenominal adjectives chain as conj of the first adjective
        (spacy: cc/conj attach to the first conjunct)."""
        nonlocal pending, pending_cc, last_head, conj_head
        nouns = [t for t in pending if t.pos_ in ("NOUN", "PROPN")]
        if not nouns:
            # adjective/det fragment with no noun; leave unattached
            pending = []
            pending_cc = []
            return None
        head = nouns[-1]
        adj_chain: Optional[Token] = None
        for t in pending:
            if t is head:
                continue
            if t.pos_ == "DET":
                t.attach(head, "det")
            elif t.pos_ == "NUM":
                t.attach(head, "nummod")
            elif t.pos_ == "ADJ":
                if adj_chain is not None and any(
                    adj_chain.i < c.i < t.i for c in pending_cc
                ):
                    t.attach(adj_chain, "conj")
                else:
                    t.attach(head, "amod")
                    adj_chain = t
            elif t.pos_ in ("NOUN", "PROPN"):
                t.attach(head, "compound")
            elif t.pos_ == "ADV":
                t.attach(head, "advmod")
        for c in pending_cc:
            if adj_chain is not None and c.i > adj_chain.i:
                c.attach(adj_chain, "cc")
            else:
                c.attach(head, "cc")
        if conj_head is not None:
            head.attach(conj_head, "conj")
            if conj_from_comma:
                # remember: this arc is only comma-licensed — if a
                # copula/verb follows, it is really a new clause's
                # subject ("a car and a cat, the car is larger ...")
                # and gets re-attached as nsubj there
                comma_conj.add(head.i)
        elif next_np_head is not None:
            head.attach(next_np_head, next_np_dep)
        else:
            head.dep_ = next_np_dep if next_np_dep != "nsubj" else "ROOT"
        pending = []
        pending_cc = []
        last_head = head
        conj_head = None
        return head

    i = 0
    n = len(doc)
    while i < n:
        tok = doc[i]
        pos = tok.pos_
        if pos in ("DET", "NUM"):
            pending.append(tok)
            expect_pred = False
        elif pos == "ADJ":
            prev = doc[i - 1] if i > 0 else None
            conj_of_pred = (
                not pending
                and last_pred_adj is not None
                and prev is not None
                and prev.pos_ in ("CCONJ", "PUNCT")
            )
            if not pending and last_verb is not None and (
                expect_pred or conj_of_pred
            ):
                # predicate adjective right after a copula/verb, or a
                # coordinated continuation of one ("... and smaller")
                if conj_of_pred:
                    tok.attach(last_pred_adj, "conj")
                else:
                    tok.attach(last_verb, "acomp")
                    last_pred_adj = tok
            else:
                pending.append(tok)
            expect_pred = False
        elif pos in ("NOUN", "PROPN"):
            pending.append(tok)
            expect_pred = False
        elif pos == "CCONJ" or (pos == "PUNCT" and tok.text == ","):
            if any(t.pos_ in ("NOUN", "PROPN") for t in pending):
                head = close_np()
                conj_head = head
                conj_from_comma = pos != "CCONJ"
                if pos == "CCONJ":
                    tok.attach(head, "cc")
            elif pending:
                # coordination among prenominal modifiers
                pending_cc.append(tok)
            elif last_pred_adj is not None and pos == "CCONJ":
                tok.attach(last_pred_adj, "cc")
            if pos == "CCONJ":
                # an explicit coordinator re-licenses the pending conj
                # arc ("a, b, and c" lists): the next NP is a true
                # conjunct, not a comma-separated clause subject
                conj_from_comma = False
            # a clause boundary comma with nothing pending: ignore
        elif pos == "ADP":
            subj = close_np()
            target = last_pred_adj or last_verb or subj or last_head
            if target is not None:
                tok.attach(target, "prep")
            next_np_head = tok
            next_np_dep = "pobj"
            conj_head = None
            expect_pred = False
        elif pos == "PRON":
            if tok.text.lower() in ("that", "which") and (
                last_head is not None or pending
            ):
                if pending:
                    close_np()
                relativizer = tok
            else:
                pending.append(tok)  # subject pronoun: acts noun-like
                tok.pos_ = "PRON"
        elif pos == "AUX":
            subj = close_np()
            nxt = doc[i + 1] if i + 1 < n else None
            if nxt is not None and nxt.pos_ == "VERB":
                # auxiliary of a following verb: "is climbing"
                tok.attach(nxt, "aux")
                i += 1
                continue
            # main copula (possibly heading a relative clause)
            if relativizer is not None and last_head is not None:
                tok.attach(last_head, "relcl")
                relativizer.attach(tok, "nsubj")
                relativizer = None
            else:
                tok.dep_ = "ROOT"
                if subj is not None:
                    # re-attach the subject under the copula
                    if subj.head is None:
                        subj.attach(tok, "nsubj")
                    elif subj.dep_ == "ROOT":
                        subj.attach(tok, "nsubj")
                        subj.dep_ = "nsubj"
                    elif subj.dep_ == "conj" and subj.i in comma_conj:
                        # comma-licensed "conj" followed by a copula is
                        # really a clause subject: "a car and a cat,
                        # the car is larger than the cat" (the HRS
                        # comparison family) — spacy parses the second
                        # "car" as nsubj of "is", which is what the
                        # verb-root extraction variant consumes
                        subj.head._children.remove(subj)
                        subj.attach(tok, "nsubj")
            last_verb = tok
            last_pred_adj = None
            next_np_head = tok
            next_np_dep = "attr"
            conj_head = None
            expect_pred = True
        elif pos == "VERB":
            subj = close_np()
            if relativizer is not None and last_head is not None:
                tok.attach(last_head, "relcl")
                relativizer.attach(tok, "nsubj")
                relativizer = None
            else:
                tok.dep_ = "ROOT"
                if subj is not None and subj.dep_ in ("ROOT", "nsubj"):
                    if subj.head is None or subj.dep_ == "ROOT":
                        subj.attach(tok, "nsubj")
                        subj.dep_ = "nsubj"
                elif (
                    subj is not None
                    and subj.dep_ == "conj"
                    and subj.i in comma_conj
                ):
                    # comma-clause subject (see the AUX branch)
                    subj.head._children.remove(subj)
                    subj.attach(tok, "nsubj")
            last_verb = tok
            last_pred_adj = None
            next_np_head = tok
            next_np_dep = "dobj"
            conj_head = None
            expect_pred = True
        elif pos == "ADV":
            if last_verb is not None and not pending:
                tok.attach(last_verb, "advmod")
            else:
                pending.append(tok)
        elif pos == "PUNCT":
            close_np()
            conj_head = None
        i += 1
    close_np()
    return doc
