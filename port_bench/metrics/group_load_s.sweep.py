"""Seconds a sweep group spends before it encodes an image: sampling the
seeds' few-shot splits, loading CLIP and encoding the class templates
(the program's ``vmap.splits``, ``vmap.clip_load`` and ``vmap.text_encode``
phase timers), per group of the window."""

from port_bench import reading


def read(record):
    groups = reading.untraced(record["groups"])
    return reading.phase(groups, "vmap.splits", "vmap.clip_load", "vmap.text_encode") / len(groups)
