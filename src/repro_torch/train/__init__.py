"""Training substrate of the port: AdamW, int8 error feedback, the Trainer."""
