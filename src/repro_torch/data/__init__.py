"""NumPy data leaves copied from ``repro.data`` (tokenizer, SynthQAServe,
arrival processes, the synthetic training batches) and the training
pipeline's device placement (``pipeline.Prefetcher``)."""
