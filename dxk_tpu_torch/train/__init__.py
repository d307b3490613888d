"""On-device PPO training of the locomotion policy (the JAX package's
train/): `ppo.make_train` and the training entry point
`python -m dxk_tpu_torch.train.train_locomotion`."""
