"""Vocabularies and the CTC label codec of the CRNN judge.

Counterpart of dpmn_tpu/utils/labels.py:36-122: get_vocabulary / char2id /
id2char (reference utils/labelmaps.py:6-37), str_filt (utils/util.py:60-72)
and the CTC codec (utils/utils_crnn.py:10-91).  Plain Python and numpy: they
run on the host at the string boundary.

DIC_36 is the VisionLAN dict-file charset, in file order: a-z, then 1..9,
then 0 (reference dic_36.txt; id 27 is '1' and id 36 is '0').
"""

from __future__ import annotations

import string

import numpy as np

DIC_36 = list(string.ascii_lowercase + "1234567890")

ALPHA_DICT = {
    "digit": string.digits,
    "lower": string.digits + string.ascii_lowercase,
    "upper": string.digits + string.ascii_letters,
    "all": string.digits + string.ascii_letters + string.punctuation,
}


def get_vocabulary(voc_type, EOS="EOS", PADDING="PADDING", UNKNOWN="UNKNOWN"):
    """The characters of `voc_type`, then EOS, PADDING and UNKNOWN."""
    if voc_type not in ALPHA_DICT:
        raise KeyError("voc_type Error")
    return list(ALPHA_DICT[voc_type]) + [EOS, PADDING, UNKNOWN]


def char2id(voc):
    return dict(zip(voc, range(len(voc))))


def id2char(voc):
    return dict(zip(range(len(voc)), voc))


def str_filt(str_, voc_type):
    """Drop the characters outside the vocabulary; lower-case for 'lower'."""
    if voc_type == "lower":
        str_ = str_.lower()
    allowed = ALPHA_DICT[voc_type]
    return "".join(c for c in str_ if c in allowed)


class CTCLabelConverter:
    """CTC codec of the CRNN recognizer: id 0 is the blank, the alphabet's
    characters are 1..len(alphabet)."""

    def __init__(self, alphabet=string.digits + string.ascii_lowercase):
        self.alphabet = alphabet + "-"  # '-' shows the blank / -1 slot
        self.dict = {c: i + 1 for i, c in enumerate(alphabet)}

    def encode(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        flat = [self.dict[c] for t in texts for c in t]
        return np.asarray(flat, np.int32), np.asarray([len(t) for t in texts], np.int32)

    def decode_single(self, ids, raw=False):
        """Collapse repeats and drop blanks (raw: every id as it is)."""
        ids = list(np.asarray(ids).reshape(-1))
        if raw:
            return "".join(self.alphabet[i - 1] for i in ids)
        return "".join(self.alphabet[t - 1] for i, t in enumerate(ids) if t != 0 and not (i > 0 and ids[i - 1] == t))

    def decode(self, ids, lengths, raw=False):
        """ids: the samples' ids concatenated; lengths: per-sample lengths."""
        ids = np.asarray(ids).reshape(-1)
        out, idx = [], 0
        for n in np.asarray(lengths).reshape(-1):
            out.append(self.decode_single(ids[idx: idx + int(n)], raw=raw))
            idx += int(n)
        return out

    def decode_logits(self, logits):
        """Greedy CTC decode of (T, B, n_class) logits into B strings: the
        argmax over the classes, repeats collapsed, blanks dropped
        (interfaces/super_resolution.py:476-489)."""
        preds = np.asarray(logits).argmax(-1)  # (T, B)
        return [self.decode_single(preds[:, b]) for b in range(preds.shape[1])]
