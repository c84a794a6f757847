"""Plain PyTorch references of the configurations' models. They import
torch and the harness's own files only: nothing of the port, of JAX or of
the JAX package."""
