"""LM training on one device: AdamW, the train step, the restartable Trainer."""
