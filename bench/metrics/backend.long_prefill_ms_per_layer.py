"""Median measured ms per layer of the longs' prefill quanta on one replica
(`EngineBackend.sp_per_layer_s()[1]`)."""


def read(run):
    v = run.sp_per_layer.get(1)
    return None if v is None else v * 1e3
