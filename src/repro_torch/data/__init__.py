"""NumPy data leaves copied from ``repro.data`` (tokenizer, SynthQAServe,
arrival processes)."""
