"""The harness: finding cells, configurations, traffic and metrics by
name, making inputs and weights, timing, tracing."""
