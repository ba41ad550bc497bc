"""Text metrics: edit distance and the accuracy / CER / WER counter.

A copy of dpmn_tpu/utils/text_metrics.py (reference
model/VisionLAN/utils.py:44-119 Attention_AR_counter, utils/meters.py:4-24
AverageMeter); the Levenshtein distance is plain Python, as the reference's
editdistance package is optional.
"""

from __future__ import annotations


def edit_distance(a, b) -> int:
    """Levenshtein distance over sequences (strings or id lists)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class AttentionARCounter:
    """Accuracy / AR / CER / WER accumulator (VisionLAN/utils.py:44-108)."""

    def __init__(self, display_string: str = "", case_sensitive: bool = False):
        self.display_string = display_string
        self.case_sensitive = case_sensitive
        self.clear()

    def clear(self):
        self.correct = 0
        self.total_samples = 0.0
        self.distance_c = 0
        self.total_c = 0.0
        self.distance_w = 0
        self.total_w = 0.0

    def add_iter(self, pred_texts, labels):
        self.total_samples += len(labels)
        out_pred, out_lab = [], []
        for pred, label in zip(pred_texts, labels):
            if not self.case_sensitive:
                pred, label = pred.lower(), label.lower()
            all_words = []
            for w in label.split("|") + pred.split("|"):
                if w not in all_words:
                    all_words.append(w)
            l_words = [all_words.index(w) for w in label.split("|")]
            p_words = [all_words.index(w) for w in pred.split("|")]
            self.distance_c += edit_distance(label, pred)
            self.distance_w += edit_distance(l_words, p_words)
            self.total_c += len(label)
            self.total_w += len(l_words)
            if label == pred:
                self.correct += 1
            out_pred.append(pred)
            out_lab.append(label)
        return out_pred, out_lab

    def metrics(self):
        return {
            "accuracy": self.correct / max(self.total_samples, 1),
            "AR": 1 - self.distance_c / max(self.total_c, 1),
            "CER": self.distance_c / max(self.total_c, 1),
            "WER": self.distance_w / max(self.total_w, 1),
        }

    def show(self):
        m = self.metrics()
        print(self.display_string)
        print("Accuracy: {accuracy:.6f}, AR: {AR:.6f}, CER: {CER:.6f}, WER: {WER:.6f}".format(**m))
        self.clear()
        return m


class AverageMeter:
    """The running value, sum, count and mean (utils/meters.py:4-24)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
