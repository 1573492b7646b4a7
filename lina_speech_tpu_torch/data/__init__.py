"""Host-side data pipeline of the port (numpy only): tokenizers, batch
collation and the synthetic TTS batches the training smoke runs use."""
