"""The LM scaffold: layers, attention, layer stacks and the Model facade."""
