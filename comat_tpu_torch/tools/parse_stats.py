"""Corpus-scale parse statistics, parse-cache export, and
miniparse↔spacy agreement measurement: the port's copy of
comat_tpu/tools/parse_stats.py over the port's own text modules
(comat_tpu_torch/text/{linguistics,miniparse,parse_cache,tokenizer}.py),
host-only, with the same modes, flags and output JSON.

The attrcon loss trains on token groups extracted from dependency
parses (reference parser: spacy en_core_web_trf —
AttrConcenTrainableSDPipeline.py:69-71). This image has no spacy, so
the in-repo miniparse fallback produces those groups; this tool makes
its behavior measurable:

  stats   — run the group-extraction pipeline over a prompt corpus and
            report yield/shape statistics (how many prompts produce
            groups, group/size distributions, top nouns). Run on the
            vendored 20k training corpus, the output is the repo's
            record of what the fallback actually feeds the loss.
  export  — serialize this host's parses (spacy when installed, else
            miniparse) to the jsonl parse-cache contract
            (text/parse_cache.py). A spacy-equipped host runs this to
            produce real en_core_web_trf parses for training
            (--parse_cache) or for the agreement diff below.
  agree   — given such a cache, extract groups twice per prompt — from
            the cached parse and from miniparse — and measure agreement
            at the group level (the quantity the loss consumes):
            exact-match rate per prompt, group precision/recall, and
            token-index jaccard.

Usage:
  python -m comat_tpu_torch.tools.parse_stats stats \
      --corpus merged_data/abc5k_hrs10k_t2icompall_20k.txt \
      [--limit N] [--out data/parse_stats_miniparse.json]
  python -m comat_tpu_torch.tools.parse_stats export --corpus X.txt --out P.jsonl
  python -m comat_tpu_torch.tools.parse_stats agree --corpus X.txt --cache P.jsonl
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, List, Optional

from comat_tpu_torch.text import linguistics, miniparse, parse_cache
from comat_tpu_torch.text.tokenizer import load_clip_tokenizer


def read_corpus(path: str, limit: Optional[int] = None) -> List[str]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line)
            if limit and len(out) >= limit:
                break
    return out


def group_key(g) -> tuple:
    """A group's identity for agreement purposes: the noun plus the
    exact CLIP token indices the loss will mask on."""
    return (g.noun, tuple(g.token_indices))


def corpus_stats(prompts: List[str], tokenizer, doc_fn=None) -> Dict:
    """Run extract_attribute_groups over the corpus; summarize."""
    n_groups = collections.Counter()     # groups-per-prompt histogram
    size_hist = collections.Counter()    # token_indices length histogram
    words_hist = collections.Counter()   # attribute word-count histogram
    noun_counts = collections.Counter()
    parse_failures = 0
    total_groups = 0
    for p in prompts:
        try:
            doc = doc_fn(p) if doc_fn is not None else None
            groups = linguistics.extract_attribute_groups(
                p, tokenizer, doc=doc
            )
        except Exception:
            parse_failures += 1
            continue
        n_groups[len(groups)] += 1
        total_groups += len(groups)
        for g in groups:
            size_hist[len(g.token_indices)] += 1
            words_hist[len(g.attribute_words)] += 1
            noun_counts[g.noun] += 1
    n = len(prompts)
    with_groups = n - n_groups[0] - parse_failures
    return {
        "prompts": n,
        "parse_failures": parse_failures,
        "prompts_with_groups": with_groups,
        "group_yield": round(with_groups / max(n, 1), 4),
        "total_groups": total_groups,
        "groups_per_prompt_mean": round(total_groups / max(n, 1), 4),
        "groups_per_prompt_hist": {
            str(k): v for k, v in sorted(n_groups.items())
        },
        "group_token_count_hist": {
            str(k): v for k, v in sorted(size_hist.items())
        },
        "attribute_word_count_hist": {
            str(k): v for k, v in sorted(words_hist.items())
        },
        "top_nouns": noun_counts.most_common(25),
    }


def agreement(prompts: List[str], cache: Dict[str, dict],
              tokenizer) -> Dict:
    """Group-level agreement between cached parses (e.g. real
    en_core_web_trf exports) and miniparse on the same prompts."""
    exact = 0
    covered = 0
    tp = fp = fn = 0
    jaccards: List[float] = []
    disagreements: List[Dict] = []
    for p in prompts:
        rec = cache.get(p)
        if rec is None:
            continue
        covered += 1
        ref_doc = parse_cache.doc_from_record(rec)
        ref = {
            group_key(g)
            for g in linguistics.extract_attribute_groups(
                p, tokenizer, doc=ref_doc
            )
        }
        ours = {
            group_key(g)
            for g in linguistics.extract_attribute_groups(
                p, tokenizer, doc=miniparse.parse(p)
            )
        }
        if ref == ours:
            exact += 1
        elif len(disagreements) < 50:
            disagreements.append({
                "prompt": p,
                "cache_only": sorted(
                    f"{n}:{list(t)}" for n, t in ref - ours
                ),
                "miniparse_only": sorted(
                    f"{n}:{list(t)}" for n, t in ours - ref
                ),
            })
        tp += len(ref & ours)
        fp += len(ours - ref)
        fn += len(ref - ours)
        union = len(ref | ours)
        jaccards.append(len(ref & ours) / union if union else 1.0)
    return {
        "prompts_in_cache": covered,
        "exact_match_rate": round(exact / max(covered, 1), 4),
        "group_precision": round(tp / max(tp + fp, 1), 4),
        "group_recall": round(tp / max(tp + fn, 1), 4),
        "mean_jaccard": round(
            sum(jaccards) / max(len(jaccards), 1), 4
        ),
        "cache_parser": next(iter(cache.values()))["parser"]
        if cache else None,
        "disagreement_examples": disagreements[:20],
    }


def gap_analysis(prompts: List[str], tokenizer) -> Dict:
    """Classify every ZERO-group prompt: is the
    zero reference-FAITHFUL (the reference pipeline would also produce
    no trainable group, because the prompt has no attribute words, or
    its only subtrees die in the reference's own >=4-member /
    blacklist / duplicate-noun filters —
    AttrConcenTrainableSDPipeline.py:281-295,
    gsam_interface.py:232-261), or a genuine miniparse MISS (the
    surface text contains a lexicon adjective the grammar failed to
    attach)? The miss buckets bound the true miniparse<->spacy gap
    from the miniparse side; `parse_stats agree` against a real
    en_core_web_trf export remains the exact check."""
    import re

    cats: collections.Counter = collections.Counter()
    examples: Dict[str, List[str]] = collections.defaultdict(list)
    comparative = re.compile(
        r"\bis (bigger|larger|smaller|taller|shorter|longer|wider"
        r"|higher|lower|faster|slower) than\b"
    )
    for p in prompts:
        groups = linguistics.extract_attribute_groups(p, tokenizer, 77)
        if groups:
            cats["has_groups"] += 1
            continue
        doc = linguistics.parse_prompt(p)
        v = linguistics.unify_lists(
            linguistics.extract_attribution_indices(doc) or [],
            linguistics.extract_attribution_indices_with_verb_root(doc)
            or [],
            linguistics.extract_attribution_indices_with_verbs(doc) or [],
        )
        if v and all(len(s) >= 4 for s in v):
            key = "faithful_zero_ref_4member_filter"
        elif v and linguistics.align_indices(
            p, [s for s in v if len(s) < 4], tokenizer
        ):
            key = "faithful_zero_ref_blacklist_or_duplicate"
        elif v:
            key = "miss_alignment_failure"
        else:
            ws = [w.strip(".,;:!?\"'()").lower() for w in p.split()]
            if not any(w in miniparse.ADJECTIVES for w in ws):
                key = "faithful_zero_no_attribute_words"
            elif comparative.search(p.lower()):
                key = "miss_comparative_clause"
            else:
                key = "miss_unattached_adjective"
        cats[key] += 1
        if key.startswith("miss") and len(examples[key]) < 25:
            examples[key].append(p)
    n = len(prompts)
    faithful = sum(v for k, v in cats.items() if k.startswith("faithful"))
    missed = sum(v for k, v in cats.items() if k.startswith("miss"))
    return {
        "prompts": n,
        "group_yield": round(cats["has_groups"] / max(n, 1), 4),
        "max_reference_faithful_yield": round(
            (cats["has_groups"] + missed) / max(n, 1), 4
        ),
        "zero_group_breakdown": dict(cats),
        "reference_faithful_zeros": faithful,
        "miniparse_miss_upper_bound": missed,
        "miss_examples": {k: v for k, v in examples.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("stats", "export", "agree", "gap"))
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache", default=None,
                    help="parse-cache jsonl (agree mode)")
    ap.add_argument("--tokenizer_dir", default=None,
                    help="HF CLIP tokenizer dir (vocab.json+merges.txt);"
                         " falls back to HashTokenizer")
    args = ap.parse_args(argv)

    prompts = read_corpus(args.corpus, args.limit)
    tokenizer = load_clip_tokenizer(args.tokenizer_dir)

    if args.mode == "export":
        if not args.out:
            ap.error("export requires --out")
        nlp = linguistics._get_spacy()
        if nlp is not None:
            meta = getattr(nlp, "meta", None) or {}
            parser = "spacy:" + str(meta.get("name", "unknown"))
            parse_fn = nlp
        else:
            parse_fn, parser = miniparse.parse, "miniparse"
        n = parse_cache.dump_parse_cache(
            args.out, prompts, parser, parse_fn
        )
        print(json.dumps({"exported": n, "parser": parser,
                          "out": args.out}))
        return 0

    if args.mode == "stats":
        rec = {
            "corpus": args.corpus,
            "parser": "spacy" if linguistics._get_spacy() is not None
            else "miniparse",
            "tokenizer": type(tokenizer).__name__,
            **corpus_stats(prompts, tokenizer),
        }
    elif args.mode == "gap":
        rec = {
            "corpus": args.corpus,
            "parser": "miniparse",
            "tokenizer": type(tokenizer).__name__,
            **gap_analysis(prompts, tokenizer),
        }
    else:
        if not args.cache:
            ap.error("agree requires --cache")
        cache = parse_cache.load_parse_cache(args.cache)
        rec = {
            "corpus": args.corpus,
            "tokenizer": type(tokenizer).__name__,
            **agreement(prompts, cache, tokenizer),
        }

    text = json.dumps(rec, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
