"""Reports over the artifacts a training run emits."""
