"""Device seconds of the losses a step: the VAE decode with its backward,
the BLIP reward, the GAN's G side, the grounding losses and D's update
(`s_decode + s_reward + s_gan_g + s_grounding + s_d_update`), mean over
the window's steps."""

KEYS = ('s_decode', 's_reward', 's_gan_g', 's_grounding', 's_d_update')


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
