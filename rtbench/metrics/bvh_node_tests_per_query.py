"""Node slab tests of the BVH walk per nearest-hit query, from the counted
kernels over every launch of the window's first frames: the tree's quality and
the walk's order (fewer is less work for the same answers). Moves
`mrays_per_s`; nothing to read where no walk ran."""


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    queries = sum(r["work"]["queries"] for r in ranks)
    tests = sum(r["work"]["node_tests"] for r in ranks)
    return tests / queries if queries and tests else None
