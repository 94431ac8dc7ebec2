"""The port's parse-statistics tool (comat_tpu_torch/tools/parse_stats.py)
against JAX's comat_tpu/tools/parse_stats.py, host-only:

- `stats` on the first 200 prompts of the 20k training corpus: the port's
  record equals JAX's dict (yield, histograms, top nouns), through `main`
  with `--out` as a user runs it;
- `export` then `agree` on the port's own miniparse export: every prompt
  in the cache, exact agreement (a parse agrees with itself), and the same
  record as JAX's `agreement` on the same cache;
- `gap` equals JAX's on the same prompts.
"""

import json
import pathlib

import pytest

from comat_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from comat_tpu.tools import parse_stats as jps
from comat_tpu_torch.text import parse_cache as tcache
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.tools import parse_stats as tps

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "merged_data" / "abc5k_hrs10k_t2icompall_20k.txt"
LIMIT = 200


def _record(main, tmp_path, name, *argv):
    out = tmp_path / f"{name}.json"
    assert main([*argv, "--corpus", str(CORPUS), "--limit", str(LIMIT),
                 "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_stats_equals_jax(tmp_path):
    got = _record(tps.main, tmp_path, "port", "stats")
    want = _record(jps.main, tmp_path, "jax", "stats")
    assert got == want
    assert got["prompts"] == LIMIT and got["prompts_with_groups"] > 0


def test_export_then_agree(tmp_path):
    cache = tmp_path / "cache.jsonl"
    assert tps.main(["export", "--corpus", str(CORPUS), "--limit", "50",
                     "--out", str(cache)]) == 0
    try:
        rec = _record(tps.main, tmp_path, "agree", "agree", "--cache", str(cache))
    finally:
        tcache.set_parse_cache(None)
    assert rec["prompts_in_cache"] == 50 and rec["exact_match_rate"] == 1.0
    prompts = tps.read_corpus(str(CORPUS), 50)
    loaded = tcache.load_parse_cache(str(cache))
    want = jps.agreement(prompts, loaded, JHashTokenizer(49408))
    assert tps.agreement(prompts, loaded, HashTokenizer(49408)) == want


@pytest.mark.parametrize("limit", [LIMIT])
def test_gap_equals_jax(limit):
    prompts = tps.read_corpus(str(CORPUS), limit)
    assert tps.gap_analysis(prompts, HashTokenizer(49408)) == jps.gap_analysis(
        prompts, JHashTokenizer(49408))
