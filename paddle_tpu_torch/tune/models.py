"""Model-name -> program-builder mapping for the autotuner.

Counterpart of paddle_tpu/tune/models.py.  `tune/rank.py` scores
Programs, not model names; this module turns the bench-suite image-model
names into `builder(batch)` callables that construct exactly the
training topology the measurement leg (`tune/leg.py`) trains:
concrete-shape feeds, softmax-with-cross-entropy loss, Momentum(0.01,
0.9), desc for desc the JAX builder's program.  So a ranked prediction
and its measured record describe the same program.

It is the port's one copy of the builder: `tools/shard_cli.py` and
`spmd/bench.py` build through it too.  Ranking needs no card, so this
module imports nothing of torch until a builder runs."""

__all__ = ["MODELS", "builder", "model_names"]

# channels / default image size / default class count per model —
# lenet5 is the canonical 1x28x28 MNIST topology (the linter's and
# the tuner selftest's flagship); the rest mirror bench.py's defaults
MODELS = {
    "lenet5": dict(channels=1, image_size=28, class_dim=10),
    "smallnet": dict(channels=3, image_size=32, class_dim=10),
    "alexnet": dict(channels=3, image_size=224, class_dim=1000),
    "vgg16": dict(channels=3, image_size=224, class_dim=1000),
    "vgg19": dict(channels=3, image_size=224, class_dim=1000),
    "googlenet": dict(channels=3, image_size=224, class_dim=1000),
    "resnet50": dict(channels=3, image_size=224, class_dim=1000),
}


def model_names():
    return sorted(MODELS)


def _model_fn(name):
    from .. import models as model_zoo

    return {"lenet5": model_zoo.lenet5,
            "smallnet": model_zoo.smallnet_mnist_cifar,
            "alexnet": model_zoo.alexnet,
            "vgg16": model_zoo.vgg16,
            "vgg19": model_zoo.vgg19,
            "googlenet": model_zoo.googlenet,
            "resnet50": model_zoo.resnet50}[name]


def builder(model, image_size=None, class_dim=None,
            with_startup=False):
    """batch -> (main_program, loss_name) for `model`.

    with_startup=True returns (main, startup, loss_name) instead:
    callers that run the program (`tune/leg.py`, `spmd/bench.py`, the
    shard CLI's selftest) need the startup program to make the
    parameters; ranking-only callers keep the two-tuple contract.

    Concrete feed shapes (append_batch_size=False, so the sharding
    analyzer sees the real batch dim), softmax_with_cross_entropy ->
    mean, Momentum(0.01, 0.9).  Unknown names raise ValueError listing
    what exists."""
    if model not in MODELS:
        raise ValueError("unknown model %r; ptune knows %s"
                         % (model, ", ".join(model_names())))
    spec = MODELS[model]
    channels = spec["channels"]
    size = int(image_size or spec["image_size"])
    classes = int(class_dim or spec["class_dim"])
    fn = _model_fn(model)

    def build(batch):
        from .. import fluid

        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            image = fluid.layers.data(
                name="image", shape=[batch, channels, size, size],
                dtype="float32", append_batch_size=False)
            logits = fn(image, class_dim=classes)
            label = fluid.layers.data(
                name="label", shape=[batch, 1], dtype="int64",
                append_batch_size=False)
            loss = fluid.layers.softmax_with_cross_entropy(logits,
                                                           label)
            avg_loss = fluid.layers.mean(loss)
            fluid.optimizer.MomentumOptimizer(
                learning_rate=0.01, momentum=0.9).minimize(avg_loss)
        if with_startup:
            return main, startup, avg_loss.name
        return main, avg_loss.name

    return build
