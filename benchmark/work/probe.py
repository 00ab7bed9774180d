"""The probe stage's least work: read each query feature (4 bytes), read
each location it has in the table once and write it once as the probe's
output, one operation a feature and a location. Locations are counted
by the reference (min(bucket size, cap) of every feature of every
window), never the program's padded row width."""


def count(stats, cfg):
    lb = stats["location_bytes"]
    return {"bytes": 4 * stats["features"] + 2 * lb * stats["locations"],
            "ops": stats["features"] + stats["locations"]}
