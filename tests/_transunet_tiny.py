"""A TransUNet small enough for CPU tests: hidden 256, 2 blocks of 4 heads,
one bottleneck unit a block at width 32, under the model name
"transunet_tiny" (registered in `models.transunet.CONFIGS` by `register`),
and the same sizes as a configuration file's keys
(`port_bench/reference/transunet.sizes`).  At 64^2 the max pool leaves
block 1 at 15^2, zero-padded to 16^2, as 127^2 is padded to 128^2 at
512^2.  Hidden 256 gives the restoration decoder n = 16, the U-Net's own
width: at hidden 64 (n = 4) its ReLUs leave whole positions zero in all
four channels, the 1 x 1 convolution after the upsample turns them into
one repeated value, and the batch norm puts that value within round-off of
zero, so which side of the next ReLU it lands on, and with it the
gradients, follows the summation order (the CPU's thread count)."""
from ramdsir_tpu_torch.models import transunet

NAME = "transunet_tiny"
TINY = transunet.TransUNetConfig(hidden_size=256, mlp_dim=512, num_heads=4, num_layers=2, resnet_units=(1, 1, 1),
                                 resnet_width=32, head_channels=64, decoder_channels=(32, 16, 16, 8))
FILE_KEYS = dict(
    hidden_size=256,
    transformer=dict(mlp_dim=512, num_heads=4, num_layers=2, attention_dropout_rate=0.0, dropout_rate=0.1),
    resnet=dict(num_layers=[1, 1, 1], width_factor=0.5),
    decoder_channels=[32, 16, 16, 8], skip_channels=[256, 128, 32, 0], n_skip=3, head_channels=64, gn_groups=32,
)


def register(monkeypatch) -> str:
    monkeypatch.setitem(transunet.CONFIGS, NAME, TINY)
    return NAME
