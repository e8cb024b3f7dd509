"""Step functions of the port: training (loss, gradients, AdamW) and serving."""
