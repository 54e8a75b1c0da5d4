"""Primitive tests per nearest-hit query, from the counted kernels over
every launch of the window's first frames: K1's brute block, after its
object cull, or the primitives of the leaves K1-bvh's walk reached. The
tests are most of a query's work, and fewer give the same answers. Moves
`mrays_per_s`; nothing to read where the counted kernel counts no tests
(K1 before the object cull)."""


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    queries = sum(r["work"]["queries"] for r in ranks)
    tests = sum(r["work"].get("tests", 0) for r in ranks)
    return tests / queries if queries and tests else None
