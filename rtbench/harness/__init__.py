"""The benchmark harness: data loading, ranks, trace reduction, the check and the result line."""
