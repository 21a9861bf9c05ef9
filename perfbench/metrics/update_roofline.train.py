"""The closed-form grouped update's share of its roofline (%): the bytes
it must move a round (W, V and the g stacked gradients read, W and V
written, every parameter) at HBM speed, over the device time of the
kernels ``harness.readers.UPDATE_KERNELS`` names, per profiled round."""
from harness.readers import update_roofline as read  # noqa: F401
