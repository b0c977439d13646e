"""``k2_roofline.silesia``'s reading, in the cells where it moves the card's
kernel time (``kernel_ms_per_GB``) rather than ``compress_MBps``."""

from dczbench.readers import load

read = load("k2_roofline.silesia")
