"""Shared synthetic-data helpers for offline dataset fallbacks."""
import numpy as np


def seq_classification(n, vocab, num_classes, seed, max_len=40):
    """Token sequences whose class is recoverable from token statistics."""
    rng = np.random.RandomState(seed)
    class_dists = rng.dirichlet(np.ones(vocab) * 0.05, size=num_classes)
    for _ in range(n):
        label = int(rng.randint(num_classes))
        length = int(rng.randint(5, max_len))
        toks = rng.choice(vocab, size=length, p=class_dists[label])
        yield list(map(int, toks)), label


def regression(n, dim, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n)).astype(np.float32)
    for i in range(n):
        yield x[i], float(y[i])
