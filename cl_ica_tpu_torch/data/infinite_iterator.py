"""Endless iterator wrapper.

Port of cl_ica_tpu/data/infinite_iterator.py."""


class InfiniteIterator:
    """Infinitely repeat an iterable by re-creating its iterator on
    exhaustion; an iterable that yields nothing raises RuntimeError."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._iterator = iter(iterable)

    def __iter__(self):
        return self

    def __next__(self):
        for _ in range(2):
            try:
                return next(self._iterator)
            except StopIteration:
                self._iterator = iter(self._iterable)
        raise RuntimeError("iterable yielded no items")
