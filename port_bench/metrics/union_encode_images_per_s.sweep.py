"""Images of the groups' few-shot unions decoded, augmented and encoded per
second of the program's ``vmap.union_encode`` phase timer."""

from port_bench import reading


def read(record):
    groups = reading.untraced(record["groups"])
    seconds = reading.phase(groups, "vmap.union_encode")
    return sum(g["union"] for g in groups) / seconds if seconds > 0 else None
