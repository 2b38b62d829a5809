"""Dense decoder models: init, forward pass, loss, weights carried across."""
