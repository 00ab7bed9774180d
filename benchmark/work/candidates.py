"""The candidate stage's least work: read each read's locations once and
write its top candidates once (target, hits, range begin and end, 4
bytes each); the operations of a comparison sort of each read's n
locations, n ceil(log2 n), and one a location for the window-range
sweep."""


def count(stats, cfg):
    return {"bytes": stats["location_bytes"] * stats["locations"] +
            16 * stats["candidates"] * stats["reads"],
            "ops": stats["sort_ops"] + stats["locations"]}
