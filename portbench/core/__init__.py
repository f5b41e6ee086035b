"""The benchmark's yardstick: spec loading, statistics, peaks, operation
counts, trace reduction, comparisons and the run driver."""
