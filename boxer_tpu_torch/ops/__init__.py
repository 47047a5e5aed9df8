"""See the package docstring of boxer_tpu_torch. The sampling ops and the
backward switch, as `boxer_tpu.ops` exports them (the name `box_attention`
is then the op; the module is `boxer_tpu_torch.ops.box_attention` in
`sys.modules`)."""

from boxer_tpu_torch.ops.box_attention import (box_attention,
                                               box_attention_dispatch,
                                               get_box_attention_impl,
                                               instance_attention,
                                               set_box_attention_impl)

__all__ = ["box_attention", "box_attention_dispatch", "instance_attention",
           "set_box_attention_impl", "get_box_attention_impl"]
