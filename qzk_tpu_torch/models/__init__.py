"""Application circuits ("models"): the Quantus wormhole
message-verification circuit family and the anonymous voting
circuit."""
