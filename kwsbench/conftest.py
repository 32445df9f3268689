"""Tiny sizes of the cells that ``kwsbench/tests/conftest.py`` does not
list, added to its ``TINY`` and ``SECONDS`` before the tests run, so that
the tests parametrized over every cell of ``BENCHMARK.json`` run them too.
Each cell's tiny configuration keeps its layout at a few channels."""

TINY_W2V = {"conv_dim": [16] * 7, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 64, "num_conv_pos_embeddings": 8, "num_conv_pos_embedding_groups": 4,
            "num_labels": 9, "batch_size": 16}
MORE_TINY = {
    "pretrain-xlsr300m-b64": {"config": TINY_W2V,
                              "traffic": {"words": 8, "clips": 4, "steps_per_epoch": 3, "expected_clips_per_s": 10}},
}
MORE_SECONDS = {"pretrain-xlsr300m-b64": 1.0}


def pytest_configure(config):
    from kwsbench.tests import conftest

    for cell, sizes in MORE_TINY.items():
        conftest.TINY.setdefault(cell, sizes)
    for cell, seconds in MORE_SECONDS.items():
        conftest.SECONDS.setdefault(cell, seconds)
