"""Bucketed sentence iterator (counterpart of
``incubator_mxnet_tpu/rnn/io.py``; ref: python/mxnet/rnn/io.py).

``BucketSentenceIter`` (:78 in the reference) is the canonical feeder for
``BucketingModule``: sentences are binned by length into buckets, and each
batch carries its ``bucket_key``, so the module binds one executor per
bucket.  The batches are made on the current context.
"""
from __future__ import annotations

import bisect
import logging
import random as pyrandom

import numpy as np

from .. import ndarray as nd
from ..io import DataIter, DataBatch, DataDesc

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token lists → int lists, growing the vocab for unknown tokens
    (ref: rnn/io.py encode_sentences:30)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max(max(vocab.values()) + 1, idx)
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    coded.append(invalid_label)
                    continue
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
                coded.append(vocab[word])
            else:
                coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketing iterator for language modelling: label[t] = data[t+1]
    (ref: rnn/io.py BucketSentenceIter:78)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in
                       enumerate(np.bincount([len(s) for s in sentences]))
                       if j >= batch_size]
        buckets = sorted(buckets)
        if not buckets:
            raise ValueError("no bucket holds >= batch_size sentences; "
                             "pass buckets= explicitly")
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets become (0, bucket_len) so downstream 2-D slicing
        # works; they simply contribute no batches
        self.data = [np.asarray(b, dtype=dtype) if b
                     else np.zeros((0, blen), dtype=dtype)
                     for b, blen in zip(self.data, buckets)]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("invalid layout %s: must contain N" % layout)
        self.provide_data = [DataDesc(data_name, shape, dtype,
                                      layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, dtype,
                                       layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    def reset(self):
        """Shuffle buckets and sentences within each (ref: io.py reset)."""
        self.curr_idx = 0
        pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, dtype=self.dtype))
            self.ndlabel.append(nd.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                self.dtype,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 self.dtype,
                                                 layout=self.layout)])
