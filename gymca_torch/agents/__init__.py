"""The PPO trainer of the port: networks, optimizer, trainer and checkpoints."""
