"""LM training: optimizers (`optimizer`), gradient compression with error
feedback (`compression`) and the train step with microbatches
(`trainer`)."""
