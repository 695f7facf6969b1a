"""Serving: prefill/decode steps, KV pools and the continuous-batching
scheduler."""
