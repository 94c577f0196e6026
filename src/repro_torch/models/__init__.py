"""The dense decoder: config, parameter table, layers, attention with a
KV cache, and the stack's train (forward), prefill and decode."""
