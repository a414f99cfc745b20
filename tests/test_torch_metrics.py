"""The port's copies of the JAX package's captioning scorers
(``utils/metrics.py``), meters (``utils/timers.py``) and
``SentencePieceBPETokenizer`` (``data/tokenizers.py``), against the
originals on the CPU:

* ``ptb3_tokens`` and ``ptb_tokenize`` on the JAX package's own golden set
  (``tests/test_metrics.py``), equal to the expected tokens and to JAX's;
* CIDEr-D on that file's case and on a seeded set of captions, equal to
  the JAX scorer's to the last bit; ``CocoCaptionsEvaluator`` the same,
  SPICE ``None`` and ``spice_score`` raising without the Java toolchain,
  as there;
* ``AverageMeter``, ``SmoothedValue`` and ``MetricLogger`` on a seeded
  stream give the JAX meters' values and strings;
* ``SentencePieceBPETokenizer`` raises as the JAX one does without the
  sentencepiece package, and pickles to its model path.
"""

import pickle

import numpy as np
import pytest

import clip_lite_tpu.data.tokenizers as jtokenizers
import clip_lite_tpu.utils.metrics as jmetrics
import clip_lite_tpu.utils.timers as jtimers
import clip_lite_torch.data.tokenizers as tokenizers
import clip_lite_torch.utils.metrics as metrics
import clip_lite_torch.utils.timers as timers
from test_metrics import GOLDEN

WORDS = ("a an the man woman dog cat horse bus pizza plate red two 3 1,000 "
         "riding sitting on with in near ( ) . , ! ? ; : \" ' don't it's "
         "we'll dogs' u.s. 3:30 50% $5 ...").split()


@pytest.mark.parametrize("caption,expected", GOLDEN,
                         ids=[c[:25] for c, _ in GOLDEN])
def test_ptb3_golden(caption, expected):
    assert metrics.ptb3_tokens(caption) == expected == \
        jmetrics.ptb3_tokens(caption)
    assert metrics.ptb_tokenize(caption) == jmetrics.ptb_tokenize(caption)


def _captions(rng, n):
    return [" ".join(rng.choice(WORDS, rng.randint(3, 14))).capitalize()
            for _ in range(n)]


def test_cider_and_evaluator_equal_jax():
    gt = {"1": ["A man riding a horse.", "a person rides a brown horse"],
          "2": ["Two dogs play with a ball.", "dogs playing fetch outside"]}
    for preds in ({"1": ["A man riding a horse."],
                   "2": ["Two dogs play with a ball."]},
                  {"1": ["an empty kitchen with white cabinets"],
                   "2": ["a jet flies over the ocean"]}):
        assert metrics.CiderScorer().compute_score(gt, preds) == \
            jmetrics.CiderScorer().compute_score(gt, preds)
    rng = np.random.RandomState(0)
    gt = {str(i): _captions(rng, 5) for i in range(40)}
    preds = [{"image_id": i, "caption": c}
             for i, c in enumerate(_captions(rng, 40))]
    ours = metrics.CocoCaptionsEvaluator(gt).evaluate(preds)
    theirs = jmetrics.CocoCaptionsEvaluator(gt).evaluate(preds)
    assert ours == theirs
    assert ours["SPICE"] is None and ours["CIDEr"] > 0
    by_id = {str(p["image_id"]): [p["caption"]] for p in preds}
    for n, sigma in ((1, 6.0), (4, 3.0)):
        assert metrics.CiderScorer(n, sigma).compute_score(gt, by_id) == \
            jmetrics.CiderScorer(n, sigma).compute_score(gt, by_id)
    assert metrics.spice_available() == jmetrics.spice_available() is False
    with pytest.raises(RuntimeError, match="SPICE needs a JVM"):
        metrics.spice_score(by_id, gt)


def test_meters_equal_jax():
    values = np.random.RandomState(1).rand(45) * 10
    ours = (timers.AverageMeter(), timers.SmoothedValue(window_size=7),
            timers.MetricLogger(delimiter=" | "))
    theirs = (jtimers.AverageMeter(), jtimers.SmoothedValue(window_size=7),
              jtimers.MetricLogger(delimiter=" | "))
    for i, v in enumerate(values):
        for meters in (ours, theirs):
            meters[0].update(v, n=1 + i % 3)
            meters[1].update(v)
            meters[2].update(loss=v, lr=v / 7)
    assert ours[0].avg == theirs[0].avg and ours[0].count == theirs[0].count
    for prop in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(ours[1], prop) == getattr(theirs[1], prop), prop
    assert str(ours[1]) == str(theirs[1])
    assert str(ours[2]) == str(theirs[2])
    assert ours[2].loss.median == theirs[2].loss.median
    with pytest.raises(AttributeError):
        ours[2].missing
    lines = []

    class Logger:
        info = lines.append

    assert list(ours[2].log_every(range(5), 2, Logger, header="h")) == \
        list(range(5))
    assert len(lines) == 3 and all(line.startswith("h [") for line in lines)
    ours[0].reset()
    assert ours[0].avg == 0.0


def test_sentencepiece_tokenizer_raises_as_jax_and_pickles():
    ours = tokenizers.SentencePieceBPETokenizer("model.spm")
    theirs = jtokenizers.SentencePieceBPETokenizer("model.spm")
    for tok in (ours, theirs):
        with pytest.raises(ImportError, match="sentencepiece"):
            len(tok)
    again = pickle.loads(pickle.dumps(ours))
    assert again.model_path == "model.spm" and again._sp is None
    assert ours.SP_SPACE == theirs.SP_SPACE
