"""Streaming metric protocol (mucon_tpu/metrics/base.py)."""


class Metric:
    def add(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.add(*args, **kwargs)

    def summary(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError
