"""Observability of the stream path: spans, counters and histograms."""
