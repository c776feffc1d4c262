"""SMILES tokenizers.

The port's own copy of ``deepchem_tpu/feat/tokenizers.py``'s
``SMI_REGEX_PATTERN``, ``BasicSmilesTokenizer`` and ``SmilesTokenizer``:
a regex pre-tokenizer and a vocabulary with BERT-style special tokens,
vocab-file compatible.  The HuggingFace featurizer bridges of that module
need ``transformers`` and are not copied.
"""

from __future__ import annotations

import collections
import os
import re
from typing import Dict, List, Optional, Sequence

# the standard SMILES regex (Schwaller et al.)
SMI_REGEX_PATTERN = (
    r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\\\|"
    r"\/|:|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")

SPECIAL_TOKENS = ('[PAD]', '[unused1]', '[unused2]', '[UNK]', '[CLS]',
                  '[SEP]', '[MASK]')


class BasicSmilesTokenizer:
    """Regex SMILES tokenizer."""

    def __init__(self, regex_pattern: str = SMI_REGEX_PATTERN):
        self.regex_pattern = regex_pattern
        self.regex = re.compile(regex_pattern)

    def tokenize(self, text: str) -> List[str]:
        return self.regex.findall(text)


class SmilesTokenizer:
    """Vocabulary-backed SMILES tokenizer with BERT-style special tokens.

    With no ``vocab_file`` (or one that does not exist) the vocabulary
    holds the special tokens only, ``[PAD]`` at id 0; :meth:`from_corpus`
    adds the corpus's tokens by falling frequency.
    """

    def __init__(self, vocab_file: Optional[str] = None):
        self.basic = BasicSmilesTokenizer()
        self.vocab: Dict[str, int] = {}
        if vocab_file and os.path.exists(vocab_file):
            with open(vocab_file) as f:
                for i, line in enumerate(f):
                    self.vocab[line.strip()] = i
        else:
            for tok in SPECIAL_TOKENS:
                self.vocab[tok] = len(self.vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.pad_token = '[PAD]'
        self.unk_token = '[UNK]'
        self.cls_token = '[CLS]'
        self.sep_token = '[SEP]'
        self.mask_token = '[MASK]'

    @classmethod
    def from_corpus(cls, smiles_list: Sequence[str]) -> 'SmilesTokenizer':
        """A vocabulary of the special tokens and every token of
        ``smiles_list``, most frequent first (ties in order of first
        appearance)."""
        tok = cls()
        counter: collections.Counter = collections.Counter()
        for s in smiles_list:
            counter.update(tok.basic.tokenize(s))
        for t, _ in counter.most_common():
            if t not in tok.vocab:
                tok.vocab[t] = len(tok.vocab)
        tok.ids_to_tokens = {v: k for k, v in tok.vocab.items()}
        return tok

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def vocab_list(self) -> List[str]:
        """Vocabulary tokens in id order."""
        return list(self.vocab.keys())

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    def tokenize(self, text: str) -> List[str]:
        return self.basic.tokenize(text)

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        unk = self.vocab[self.unk_token]
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str, max_length: Optional[int] = None,
               add_special_tokens: bool = True,
               padding: bool = True) -> List[int]:
        """Token ids of ``text``: ``[CLS] tokens [SEP]`` with
        ``add_special_tokens``, cut to ``max_length`` and, with
        ``padding``, filled up to it with ``[PAD]``."""
        toks = self.tokenize(text)
        if add_special_tokens:
            toks = [self.cls_token] + toks + [self.sep_token]
        ids = self.convert_tokens_to_ids(toks)
        if max_length is not None:
            ids = ids[:max_length]
            if padding:
                ids = self.add_padding_tokens(ids, max_length)
        return ids

    def decode(self, ids) -> str:
        """The SMILES of ``ids``, without ``[PAD]``, ``[CLS]`` and
        ``[SEP]``."""
        skip = (self.pad_token, self.cls_token, self.sep_token)
        return ''.join(t for t in self.convert_ids_to_tokens(ids)
                       if t not in skip)

    def add_padding_tokens(self, ids: List[int], length: int) -> List[int]:
        return list(ids) + [self.pad_token_id] * (length - len(ids))

    def save_vocabulary(self, vocab_path: str) -> str:
        """Write one token a line in id order to ``vocab_path`` (or
        ``vocab_path/vocab.txt`` for a directory); returns the path."""
        path = os.path.join(vocab_path, 'vocab.txt') \
            if os.path.isdir(vocab_path) else vocab_path
        with open(path, 'w') as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + '\n')
        return path
