"""The port's Tamil stemmer (``orama_core_tpu_torch/nlp/stemmer_extra.py``)
against the reference's (``orama_core_tpu/nlp/stemmer_extra.py``): stems
are part of the on-disk format (the token ids of a committed index), so
the two must agree on every word, the reference's defects included.

One such defect: ``tamil_stem`` returns a word of fewer than 3
characters unchanged, so ``'்்'`` (a doubled virama) keeps its doubled
virama, which ``tests/test_property.py::test_tamil_stemmer_invariants``
forbids. Both stemmers do so; the case is checked here as it stands, and
the fix belongs to the reference first."""

import itertools

import numpy as np
import pytest

from orama_core_tpu.nlp import stemmer_extra as ref
from orama_core_tpu_torch.nlp import stemmer_extra as port

VIRAMA = "்"
TAMIL = [chr(c) for c in range(0x0B80, 0x0C00)]  # the Unicode block


def test_doubled_virama_is_kept_by_both():
    """The short-word path: '்்' comes back unchanged from both."""
    assert ref.tamil_stem(VIRAMA * 2) == VIRAMA * 2
    assert port.tamil_stem(VIRAMA * 2) == VIRAMA * 2


@pytest.mark.parametrize("length", [1, 2, 3])
def test_short_words_ending_in_a_virama_agree(length):
    """Every string of ``length`` Tamil-block characters that ends in a
    virama (1, 128 and 16,384 strings)."""
    for head in itertools.product(TAMIL, repeat=length - 1):
        word = "".join(head) + VIRAMA
        assert port.tamil_stem(word) == ref.tamil_stem(word), word


@pytest.mark.parametrize("seed", [0, 1])
def test_random_tamil_words_agree(seed):
    """200 seeded words of 1-25 Tamil-block characters per seed, as
    test_tamil_stemmer_invariants draws them, plus 100 built from the
    rules' own suffixes, so that every step of the stemmer fires."""
    rng = np.random.default_rng(seed)
    suffixes = sorted({suf for rules, _ms in ref._TA_STEPS
                       for suf, _rep in rules}
                      | {suf for suf, _rep in ref._TA_TENSE})
    words = ["".join(rng.choice(TAMIL, int(rng.integers(1, 26))))
             for _ in range(200)]
    words += ["".join(rng.choice(TAMIL, int(rng.integers(1, 6))))
              + "".join(rng.choice(suffixes, int(rng.integers(1, 4))))
              for _ in range(100)]
    for word in words:
        assert port.tamil_stem(word) == ref.tamil_stem(word), word
