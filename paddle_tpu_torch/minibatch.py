"""minibatch.batch — group a sample reader into batches (a copy of
``paddle_tpu/minibatch.py``).  ``drop_last`` defaults True, as there."""

from __future__ import annotations


def batch(reader, batch_size: int, drop_last: bool = True):
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
