"""The victims' FLOP counts against a hand count at a tiny size."""

from bench_port import harness

POINTNET = {"input_channels": 3, "tnet_conv": [2, 3, 4], "tnet_fc": [3, 2],
            "mlp1": [2], "mlp2": [3, 4], "head_fc": [3, 2],
            "num_classes": 5}
DGCNN = {"input_channels": 3, "edge_conv": [2, 2, 3, 4], "emb_dims": 6,
         "head_fc": [3, 2], "num_classes": 5}


def _mod(name):
    return harness.load_module(harness.HERE / "configs" / f"{name}.py")


def test_pointnet_flops():
    m, n = _mod("pointnet"), 7
    # T-Net on 3 channels: convs 3-2-3-4, fcs 4-3-2-9
    t3 = 2 * n * (3 * 2 + 2 * 3 + 3 * 4) + 2 * (4 * 3 + 3 * 2 + 2 * 9)
    # T-Net on 2 channels: convs 2-2-3-4, fcs 4-3-2-4
    t2 = 2 * n * (2 * 2 + 2 * 3 + 3 * 4) + 2 * (4 * 3 + 3 * 2 + 2 * 4)
    body = (2 * 3 * 3 * 2 + 2 * n * 3 * 2      # T folded into conv1, conv1
            + 2 * 2 * 2 * 3 + 2 * n * 2 * 3    # T folded into conv2, conv2
            + 2 * n * 3 * 4                    # conv3
            + 2 * (4 * 3 + 3 * 2 + 2 * 5))     # head
    assert m.forward_flops(POINTNET, n) == t3 + t2 + body
    # fcs of both T-Nets and of the head, and each max-pool's routed rows
    grad = (2 * (4 * 3 + 3 * 2 + 2 * 9) + 2 * 3 * 4
            + 2 * (4 * 3 + 3 * 2 + 2 * 4) + 2 * 3 * 4
            + 2 * (4 * 3 + 3 * 2 + 2 * 5) + 2 * 3 * 4)
    assert m.input_grad_flops(POINTNET, n) == grad


def test_dgcnn_flops():
    m, n = _mod("dgcnn"), 7
    edge = 4 * n * (3 * 2 + 2 * 2 + 2 * 3 + 3 * 4)
    emb = 2 * n * 11 * 6
    head = 2 * (12 * 3 + 3 * 2 + 2 * 5)
    assert m.forward_flops(DGCNN, n) == edge + emb + head
    assert m.input_grad_flops(DGCNN, n) == edge // 2 + emb + head


def test_tree_sizes():
    m = _mod("pointnet")
    tree = m.tree(harness.read_json(harness.HERE / "configs"
                                    / "pointnet.json"))
    assert tree["conv3"]["w"][1] == (128, 1024)
    assert tree["fstn"]["fc3"]["w"][1] == (256, 64 * 64)
