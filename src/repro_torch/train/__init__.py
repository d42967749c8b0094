"""Training stack of the port: optimizers, the train step, the RStore-backed
versioned checkpointer and update compression."""
