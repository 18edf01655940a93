"""Corpus & lexicon prep layer (ref: JLM:data/ — SURVEY.md §2 L0, §5.1).

Token format: ``display/reading/POS`` triples, one sentence per line,
space-separated (SURVEY.md §4.1).  Outputs: frequency-ordered vocab,
reading→word-ids lexicon, encoded int32 corpus arrays.
"""

from jlm.data.corpus import (  # noqa: F401
    Token,
    Vocab,
    parse_line,
    build_vocab,
    encode_corpus,
    split_corpus,
)
from jlm.data.lexicon import Lexicon  # noqa: F401
from jlm.data.streaming import (  # noqa: F401
    build_vocab_file,
    encode_corpus_file,
    save_dataset_streamed,
    stream_lines,
)
from jlm.data.reader import bptt_batches  # noqa: F401
from jlm.data.synthetic import (  # noqa: F401
    SYNTH_WORDS,
    generate_corpus,
    generate_test_set,
)
