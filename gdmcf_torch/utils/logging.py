"""Structured metric logging: the human-readable lines of ``output_NDCG.txt``
(the reference redirects stdout there) plus a machine-readable
``metrics.jsonl`` stream. Port of the JAX package's ``utils/logging.py``."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, TextIO


class MetricLogger:
    def __init__(self, out_dir: Optional[str] = None, echo: bool = True,
                 text: bool = True):
        """``text=False`` skips the output_NDCG.txt handle — pass it when
        sys.stdout is already redirected to that file (the CLI's non-debug
        mode): two live buffered handles on one file interleave badly."""
        self.echo = echo
        self._jsonl: Optional[TextIO] = None
        self._text: Optional[TextIO] = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if text:
                self._text = open(os.path.join(out_dir, "output_NDCG.txt"),
                                  "a")

    def log(self, message: str) -> None:
        if self.echo:
            print(message)
            sys.stdout.flush()
        if self._text:
            self._text.write(message + "\n")
            self._text.flush()

    def metrics(self, step: int, **values) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": step, "time": time.time(), **values}) + "\n")
            self._jsonl.flush()

    def eval_results(self, epoch: int, split: str, topn, results) -> None:
        precision, recall, ndcg, mrr = results
        self.metrics(epoch, split=split,
                     **{f"precision@{k}": p for k, p in zip(topn, precision)},
                     **{f"recall@{k}": r for k, r in zip(topn, recall)},
                     **{f"ndcg@{k}": n for k, n in zip(topn, ndcg)},
                     **{f"mrr@{k}": m for k, m in zip(topn, mrr)})

    def close(self) -> None:
        for fh in (self._jsonl, self._text):
            if fh:
                fh.close()
