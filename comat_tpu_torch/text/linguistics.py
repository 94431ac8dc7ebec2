"""Prompt linguistics: attribute-noun subtree mining + wordpiece align.

The port's own copy of comat_tpu/text/linguistics.py, unchanged but
for this paragraph and its imports; the port imports nothing of the JAX
package. spacy stays an optional import, tried at the first parse.

Re-implements the reference's full extraction pipeline
(attribute_concen_utils.py, AttrConcenTrainableSDPipeline.py:281-298,
:539-563, attr_concen_utils/gsam_interface.py:160-261):

  1. dependency parse (spacy en_core_web_trf when importable —
     AttrConcenTrainableSDPipeline.py:69-71 — else the rule-based
     miniparse for the corpora grammar);
  2. THREE subtree extraction variants: `extract_attribution_indices`
     (:39), `extract_attribution_indices_with_verbs` (:64),
     `extract_attribution_indices_with_verb_root` (:95), merged by
     `unify_lists` (AttrConcenTrainableSDPipeline.py:543-563) and
     filtered to pairs shorter than 4 members (:293);
  3. CLIP wordpiece alignment with multi-wordpiece expansion and
     cross-pair index dedup (`align_wordpieces_indices` :11,
     `_align_indices` AttrConcenTrainableSDPipeline.py:298-338);
  4. flattening into per-group token-index sets with the noun folded in
     (gsam_interface.py:166-185) plus duplicate/blacklist noun
     filtering (`update_nouns_attributes` :232-261).

All of this is host-side preprocessing outside the jit boundary; the
output feeds the fixed-shape grounding loss via `pad_groups`.

Reference quirks preserved on purpose (they shape which token groups
the loss sees): `…_with_verbs` returns after the first processed noun
(the reference's `return` sits inside its token loop, :90-93); the
"noun" of a verb-root subtree is its LAST member, which can be the
predicate adjective (gsam_interface.py:172); wordpiece matching is
case-sensitive, so capitalized surface forms silently contribute no
indices; a noun duplicated across groups drops ALL its groups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from comat_tpu_torch.text import miniparse

START_TOKEN = "<|startoftext|>"
END_TOKEN = "<|endoftext|>"

# Nouns the reference refuses to ground (gsam_interface.py:247-251) —
# background/scene words that segment poorly.
INVALID_NOUNS = {
    "scene", "surface", "area", "atmosphere", "noise", "place", "kitchen",
    "dream", "interior", "exterior", "meal", "background", "bathroom",
    "room", "scent", "street", "hillside", "mountain", "sky", "sea",
    "ocean", "lost", "language", "skill", "one", "night", "day",
    "morning", "space", "environment", "conditions", "field", "shore",
    "restroom", "party", "grass", "snow", "meadow", "water", "shadow",
    "waves", "song", "cycle", "sunlight", "mysteries", "wall", "salon",
    "range", "cry", "speech", "tone", "thing", "about", "activity",
    "air", "advertisement", "airport", "also",
}


@dataclasses.dataclass
class AttributeGroup:
    attribute_words: List[str]
    noun: str
    # CLIP token indices (1-based, BOS at 0): attributes + noun combined
    # (the reference folds noun tokens into the attribute group —
    # gsam_interface.py:184)
    token_indices: List[int]


_NLP = None
_NLP_TRIED = False


def _get_spacy():
    global _NLP, _NLP_TRIED
    if _NLP_TRIED:
        return _NLP
    _NLP_TRIED = True
    try:
        import spacy

        for model in ("en_core_web_trf", "en_core_web_sm"):
            try:
                _NLP = spacy.load(model)
                break
            except Exception:
                continue
    except Exception:
        _NLP = None
    return _NLP


def parse_prompt(prompt: str):
    """Dependency-parse one prompt: an armed parse cache first (real
    en_core_web_trf parses exported by a spacy-equipped host —
    text/parse_cache.py, trainer flag --parse_cache), then spacy when
    available (the reference's parser,
    AttrConcenTrainableSDPipeline.py:69-71), else the rule-based
    miniparse with the same doc interface."""
    from comat_tpu_torch.text import parse_cache

    cached = parse_cache.lookup(prompt)
    if cached is not None:
        return cached
    nlp = _get_spacy()
    if nlp is not None:
        return nlp(prompt)
    return miniparse.parse(prompt)


# ---------------------------------------------------------------------
# Subtree extraction — exact ports of attribute_concen_utils.py:39-131.
# Each operates on any doc whose tokens expose .pos_/.dep_/.children.
# ---------------------------------------------------------------------

def extract_attribution_indices(doc) -> List[list]:
    """Standard pattern (attribute_concen_utils.py:39-62): for each
    noun head, collect direct modifier children plus their conj
    chains (DFS, LIFO pop order), noun appended last."""
    subtrees = []
    modifiers = ["amod", "nmod", "compound", "npadvmod", "advmod", "acomp"]
    for w in doc:
        if w.pos_ not in ["NOUN", "PROPN"] or w.dep_ in modifiers:
            continue
        subtree = []
        stack = []
        for child in w.children:
            if child.dep_ in modifiers:
                subtree.append(child)
                stack.extend(child.children)
        while stack:
            node = stack.pop()
            if node.dep_ in modifiers or node.dep_ == "conj":
                subtree.append(node)
                stack.extend(node.children)
        if subtree:
            subtree.append(w)
            subtrees.append(subtree)
    return subtrees


def extract_attribution_indices_with_verbs(doc) -> Optional[List[list]]:
    """Verb-mediated modifiers via relative clauses ("a dog that is
    red"): 'relcl' joins the modifier set and AUX/VERB nodes are
    traversed but not collected (attribute_concen_utils.py:64-93).
    Reference quirk kept: returns at the end of the FIRST processed
    noun's iteration (the `return` is inside the loop, :93), or None
    when no noun is reached — call sites use `or []` like the
    reference (AttrConcenTrainableSDPipeline.py:288)."""
    subtrees = []
    modifiers = [
        "amod", "nmod", "compound", "npadvmod", "advmod", "acomp", "relcl",
    ]
    for w in doc:
        if w.pos_ not in ["NOUN", "PROPN"] or w.dep_ in modifiers:
            continue
        subtree = []
        stack = []
        for child in w.children:
            if child.dep_ in modifiers:
                if child.pos_ not in ["AUX", "VERB"]:
                    subtree.append(child)
                stack.extend(child.children)
        while stack:
            node = stack.pop()
            if node.dep_ in modifiers or node.dep_ == "conj":
                if node.pos_ not in ["AUX", "VERB"]:
                    subtree.append(node)
                stack.extend(node.children)
        if subtree:
            subtree.append(w)
            subtrees.append(subtree)
        return subtrees
    return None


def extract_attribution_indices_with_verb_root(doc) -> List[list]:
    """Copula-rooted pattern ("the cat is black"): an AUX with both a
    noun child and a modifier child yields a subtree of the two, the
    AUX itself excluded (attribute_concen_utils.py:95-131). The noun
    comes FIRST here, so the downstream "noun = last member" rule picks
    the predicate adjective — reference behavior, kept."""
    subtrees = []
    modifiers = ["amod", "nmod", "compound", "npadvmod", "advmod", "acomp"]
    for w in doc:
        subtree = []
        stack = []
        if w.pos_ != "AUX" or w.dep_ in modifiers:
            continue
        for child in w.children:
            if child.dep_ in modifiers or child.pos_ in ["NOUN", "PROPN"]:
                if child.pos_ not in ["AUX", "VERB"]:
                    subtree.append(child)
                stack.extend(child.children)
        if len(subtree) < 2:
            continue
        while stack:
            node = stack.pop()
            if node.dep_ in modifiers or node.dep_ == "conj":
                if node.pos_ not in ["AUX"]:
                    subtree.append(node)
                stack.extend(node.children)
        if subtree:
            if w.pos_ not in ["AUX"]:
                subtree.append(w)
            subtrees.append(subtree)
    return subtrees


def is_sublist(sub: list, main: list) -> bool:
    """AttrConcenTrainableSDPipeline.py:539-541."""
    return len(sub) < len(main) and all(item in main for item in sub)


def unify_lists(lists_1: List[list], lists_2: List[list],
                lists_3: List[list]) -> List[list]:
    """Merge the three variants' subtrees, dropping duplicates and any
    subtree strictly contained in a longer one
    (AttrConcenTrainableSDPipeline.py:543-563)."""
    unified_list = lists_1 + lists_2 + lists_3
    sorted_list = sorted(unified_list, key=len)
    seen = set()
    result = []
    for i in range(len(sorted_list)):
        if tuple(sorted_list[i]) in seen:
            continue
        sublist_to_add = True
        for j in range(i + 1, len(sorted_list)):
            if is_sublist(sorted_list[i], sorted_list[j]):
                sublist_to_add = False
                break
        if sublist_to_add:
            result.append(sorted_list[i])
            seen.add(tuple(sorted_list[i]))
    return result


def extract_attribution_pairs(prompt: str, doc=None) -> List[list]:
    """All three variants + unify + the <4-member filter
    (AttrConcenTrainableSDPipeline.py:281-295). `doc` overrides the
    parser (used by tools/parse_stats to diff two parsers' groups)."""
    if doc is None:
        doc = parse_prompt(prompt)
    pairs = extract_attribution_indices(doc) or []
    pairs_2 = extract_attribution_indices_with_verb_root(doc) or []
    pairs_3 = extract_attribution_indices_with_verbs(doc) or []
    pairs = unify_lists(pairs, pairs_2, pairs_3)
    return [p for p in pairs if len(p) < 4]


# ---------------------------------------------------------------------
# Wordpiece alignment — attribute_concen_utils.py:11-36,134-155 and
# AttrConcenTrainableSDPipeline.py:298-338.
# ---------------------------------------------------------------------

def get_indices(tokenizer, prompt: str) -> Dict[int, str]:
    """{position: wordpiece string} over the UNtruncated encoding,
    BOS/EOS included (attribute_concen_utils.py:134-143)."""
    tokens = tokenizer.encode_to_tokens(prompt)
    return {i: tok for i, tok in enumerate(tokens)}


def get_attention_map_index_to_wordpiece(
    tokenizer, prompt: str
) -> Dict[int, str]:
    """Same map minus BOS/EOS, '</w>' stripped
    (attribute_concen_utils.py:145-155)."""
    attn_map_idx_to_wp = {}
    wordpieces2indices = get_indices(tokenizer, prompt)
    for i in list(wordpieces2indices.keys())[1:-1]:
        attn_map_idx_to_wp[i] = wordpieces2indices[i].replace("</w>", "")
    return attn_map_idx_to_wp


def align_wordpieces_indices(
    wordpieces2indices: Dict[int, str], start_idx: int, target_word: str
) -> List[int]:
    """Greedy multi-wordpiece span match
    (attribute_concen_utils.py:11-36)."""
    wp_indices = [start_idx]
    wp = wordpieces2indices[start_idx].replace("</w>", "")
    for wp_idx in range(start_idx + 1, len(wordpieces2indices)):
        if wp == target_word:
            break
        wp2 = wordpieces2indices[wp_idx].replace("</w>", "")
        if target_word.startswith(wp + wp2) and wp2 != target_word:
            wp += wordpieces2indices[wp_idx].replace("</w>", "")
            wp_indices.append(wp_idx)
        else:
            wp_indices = []
            break
    return wp_indices


AlignedPair = List[Union[int, List[int]]]


def align_indices(prompt: str, spacy_pairs: List[list],
                  tokenizer) -> List[AlignedPair]:
    """Map subtree members to wordpiece positions, tracking already-
    claimed indices so repeated surface forms advance to their next
    occurrence (AttrConcenTrainableSDPipeline.py:298-338)."""
    wordpieces2indices = get_indices(tokenizer, prompt)
    paired_indices: List[AlignedPair] = []
    collected_spacy_indices = set()
    for pair in spacy_pairs:
        curr_collected_wp_indices: AlignedPair = []
        for member in pair:
            for idx, wp in wordpieces2indices.items():
                if wp in [START_TOKEN, END_TOKEN]:
                    continue
                wp = wp.replace("</w>", "")
                if member.text == wp:
                    if (
                        idx not in curr_collected_wp_indices
                        and idx not in collected_spacy_indices
                    ):
                        curr_collected_wp_indices.append(idx)
                        break
                elif member.text.startswith(wp) and wp != member.text:
                    wp_indices = align_wordpieces_indices(
                        wordpieces2indices, idx, member.text
                    )
                    if (
                        wp_indices
                        and (wp_indices not in curr_collected_wp_indices)
                        and all(
                            wp_idx not in collected_spacy_indices
                            for wp_idx in wp_indices
                        )
                    ):
                        curr_collected_wp_indices.append(wp_indices)
                        break
        for collected_idx in curr_collected_wp_indices:
            if isinstance(collected_idx, list):
                for idx in collected_idx:
                    collected_spacy_indices.add(idx)
            else:
                collected_spacy_indices.add(collected_idx)
        paired_indices.append(curr_collected_wp_indices)
    return paired_indices


# ---------------------------------------------------------------------
# Group flattening + noun filtering — gsam_interface.py:160-261.
# ---------------------------------------------------------------------

def update_nouns_attributes(nouns: List[str], attributes: List[List[int]]):
    """Drop duplicated nouns (all occurrences) then blacklisted nouns,
    with the reference's singular/plural `n[:-1]` check
    (gsam_interface.py:232-261)."""
    new_nouns: List[str] = []
    new_attributes: List[List[int]] = []
    nouns2idx: Dict[str, List[int]] = {}
    for idx, n in enumerate(nouns):
        nouns2idx.setdefault(n, []).append(idx)
    for n in nouns2idx:
        if len(nouns2idx[n]) > 1:
            continue
        new_nouns.append(n)
        new_attributes.append(attributes[nouns2idx[n][0]])
    filtered_nouns, filtered_attributes = [], []
    for idx, n in enumerate(new_nouns):
        if n in INVALID_NOUNS or n[:-1] in INVALID_NOUNS:
            continue
        filtered_nouns.append(n)
        filtered_attributes.append(new_attributes[idx])
    return filtered_nouns, filtered_attributes


def extract_attribute_groups(
    prompt: str, tokenizer, max_length: int = 77, doc=None
) -> List[AttributeGroup]:
    """Full pipeline for one prompt: parse -> three variants -> unify
    -> align -> flatten (noun = last member, noun indices folded into
    the group, gsam_interface.py:166-185) -> duplicate/blacklist noun
    filtering. Groups whose indices would fall outside the [1,
    max_length-2] attention-map range are dropped (the reference's
    fixed 77-position maps). `doc` overrides the parser (see
    extract_attribution_pairs)."""
    pairs = extract_attribution_pairs(prompt, doc=doc)
    aligned = align_indices(prompt, pairs, tokenizer)
    idx_to_wp = get_attention_map_index_to_wordpiece(tokenizer, prompt)

    nouns: List[str] = []
    attributes: List[List[int]] = []
    words: List[List[str]] = []
    for subtree in aligned:
        if len(subtree) < 1:
            continue
        noun_indices = (
            subtree[-1] if isinstance(subtree[-1], list) else [subtree[-1]]
        )
        noun = "".join(idx_to_wp[i] for i in noun_indices)
        attribute: List[int] = []
        for attribute_char in subtree[:-1]:
            if isinstance(attribute_char, list):
                attribute.extend(attribute_char)
            else:
                attribute.append(attribute_char)
        attr_words = [idx_to_wp[i] for i in attribute]
        attribute.extend(noun_indices)
        nouns.append(noun)
        attributes.append(attribute)
        words.append(attr_words)
    noun_words = dict(zip(nouns, words))
    nouns, attributes = update_nouns_attributes(nouns, attributes)

    groups: List[AttributeGroup] = []
    for noun, attribute in zip(nouns, attributes):
        if attribute and max(attribute) < max_length - 1:
            groups.append(
                AttributeGroup(noun_words.get(noun, []), noun, attribute)
            )
    return groups


def pad_groups(
    all_groups: Sequence[List[AttributeGroup]],
    max_words: int = 8,
    max_tokens: int = 8,
) -> Dict[str, np.ndarray]:
    """Batch the ragged groups into fixed-shape arrays for the jitted
    grounding loss:
      token_idx  (B, W, T) int32 — CLIP positions, 0-padded
      token_valid(B, W, T) bool
      word_valid (B, W)    bool
    plus the noun strings per sample (host-side, for the segmenter).
    """
    B = len(all_groups)
    token_idx = np.zeros((B, max_words, max_tokens), np.int32)
    token_valid = np.zeros((B, max_words, max_tokens), bool)
    word_valid = np.zeros((B, max_words), bool)
    nouns: List[List[str]] = []
    for b, groups in enumerate(all_groups):
        nouns.append([g.noun for g in groups[:max_words]])
        for w, g in enumerate(groups[:max_words]):
            ts = g.token_indices[:max_tokens]
            token_idx[b, w, : len(ts)] = ts
            token_valid[b, w, : len(ts)] = True
            word_valid[b, w] = len(ts) > 0
    return {
        "token_idx": token_idx,
        "token_valid": token_valid,
        "word_valid": word_valid,
        "nouns": nouns,
    }
